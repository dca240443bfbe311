"""EfficientNet family, served as the zoo's ``efficientnetb7`` (port of the
JAX package's ``models/efficientnet.py``).

Keras EfficientNet normalizes its input inside the model — ``rescaling``
(x / 255), a ``normalization`` layer ``(x - mean) / sqrt(var)`` with
ImageNet statistics held as float32 buffers, and, for ImageNet weights,
``rescaling_1`` (x / sqrt(std), the original TF implementation's quirk) —
so it takes raw [0, 255] RGB and the zoo registers preprocess mode
``identity``.

MBConv blocks as in Keras: expand 1x1 conv + BN + swish, depthwise + BN +
swish, squeeze-excite (``se_squeeze`` GAP, ``se_reshape``, two 1x1 convs,
``se_excite`` multiply), project 1x1 conv + BN, and on identity blocks a
stochastic-depth drop (whole samples; identity when serving) and the
residual add. Width and depth scale by ``round_filters`` /
``round_repeats``: B7 (width 2.0, depth 3.1) has 55 blocks; at 128x128, 51
of its depthwise layers are stride-1 ``SAME`` (3x3 and 5x5, up to C=3840:
the CUDA depthwise kernel) and 4 stride-2 behind a zero pad (grouped conv).
Fresh convs start from Keras's variance-scaling initializer.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.models import common as C

# ImageNet RGB statistics on the [0, 1] scale (Keras EfficientNet's
# in-model normalization).
TORCH_MEAN_RGB = np.array([0.485, 0.456, 0.406], dtype=np.float32)
TORCH_STD_RGB = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# (kernel, repeats, filters_in, filters_out, expand_ratio, stride, se_ratio)
EFFNET_BLOCK_ARGS = (
    (3, 1, 32, 16, 1, 1, 0.25),
    (3, 2, 16, 24, 6, 2, 0.25),
    (5, 2, 24, 40, 6, 2, 0.25),
    (3, 3, 40, 80, 6, 2, 0.25),
    (5, 3, 80, 112, 6, 1, 0.25),
    (5, 4, 112, 192, 6, 2, 0.25),
    (3, 1, 192, 320, 6, 1, 0.25),
)

EFFNET_PARAMS = {
    # name: (width_coefficient, depth_coefficient, dropout_rate)
    "b0": (1.0, 1.0, 0.2),
    "b1": (1.0, 1.1, 0.2),
    "b2": (1.1, 1.2, 0.3),
    "b3": (1.2, 1.4, 0.3),
    "b4": (1.4, 1.8, 0.4),
    "b5": (1.6, 2.2, 0.4),
    "b6": (1.8, 2.6, 0.5),
    "b7": (2.0, 3.1, 0.5),
}

_BN = dict(momentum=0.99, epsilon=1e-3)


def round_filters(filters: float, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def _conv_init(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Keras EfficientNet's CONV_KERNEL_INITIALIZER: variance scaling 2.0,
    fan_out, truncated normal. On a depthwise ``[C, 1, K, K]`` weight the
    Keras layout's fan_out (K*K) is this layout's fan_in."""
    mode = "fan_in" if isinstance(module, G.DepthwiseConv) else "fan_out"
    C.variance_scaling_(module.weight, generator, mode, "truncated_normal")


def _conv(*args, **kwargs) -> G.LayerSpec:
    return G.with_init(G.conv2d(*args, **kwargs), _conv_init)


def _dwconv(*args, **kwargs) -> G.LayerSpec:
    return G.with_init(G.depthwise_conv2d(*args, **kwargs), _conv_init)


def _rescale(scale: np.ndarray):
    """``x * scale[c]`` per channel, the constant cast to ``x``'s dtype
    (kept per device and dtype, so a forward copies nothing to the card)."""
    const = torch.as_tensor(scale, dtype=torch.float32).view(1, -1, 1, 1)
    cache = {}

    def fn(x: torch.Tensor) -> torch.Tensor:
        key = (x.device, x.dtype)
        if key not in cache:
            cache[key] = const.to(device=x.device, dtype=x.dtype)
        return x * cache[key]
    return fn


def efficientnet_backbone(variant: str = "b7",
                          input_size: Tuple[int, int] = (128, 128),
                          drop_connect_rate: float = 0.2,
                          imagenet_stem: bool = True) -> G.LayerGraph:
    """Keras-exact EfficientNet backbone. ``imagenet_stem=False`` drops
    ``rescaling_1`` and gives the normalization (0, 1) statistics, as a
    Keras model built with ``weights=None`` (layer indices shift by one)."""
    width, depth, _ = EFFNET_PARAMS[variant]
    specs: List[G.LayerSpec] = []
    size = tuple(input_size)
    swish = F.silu

    specs.append(G.activation("rescaling", G.INPUT, lambda x: x / 255.0))
    if imagenet_stem:
        specs.append(G.normalization("normalization", "rescaling",
                                     mean=TORCH_MEAN_RGB,
                                     variance=TORCH_STD_RGB ** 2))
        specs.append(G.activation("rescaling_1", "normalization",
                                  _rescale(1.0 / np.sqrt(TORCH_STD_RGB))))
        stem_in = "rescaling_1"
    else:
        specs.append(G.normalization("normalization", "rescaling",
                                     mean=(0.0, 0.0, 0.0),
                                     variance=(1.0, 1.0, 1.0)))
        stem_in = "normalization"

    stem_filters = round_filters(32, width)
    specs.append(G.zero_pad("stem_conv_pad", stem_in, C.correct_pad(size, 3)))
    specs.append(_conv("stem_conv", "stem_conv_pad", 3, stem_filters,
                          (3, 3), strides=(2, 2), padding="VALID",
                          use_bias=False))
    size = C.stride2_out(size)
    specs.append(G.batch_norm("stem_bn", "stem_conv", stem_filters, **_BN))
    specs.append(G.activation("stem_activation", "stem_bn", swish))
    prev, in_ch = "stem_activation", stem_filters

    total_blocks = sum(round_repeats(r, depth)
                       for _, r, *_ in EFFNET_BLOCK_ARGS)
    block_num = 0
    for stage_idx, (kernel, repeats, _, f_out, expand, stride,
                    se_ratio) in enumerate(EFFNET_BLOCK_ARGS, start=1):
        filters_out = round_filters(f_out, width)
        for rep in range(round_repeats(repeats, depth)):
            b = f"block{stage_idx}{chr(ord('a') + rep)}"
            s = stride if rep == 0 else 1
            filters = in_ch * expand
            drop_rate = drop_connect_rate * block_num / total_blocks

            x = prev
            if expand != 1:
                specs.append(_conv(f"{b}_expand_conv", x, in_ch, filters,
                                      (1, 1), use_bias=False))
                specs.append(G.batch_norm(f"{b}_expand_bn",
                                          f"{b}_expand_conv", filters, **_BN))
                specs.append(G.activation(f"{b}_expand_activation",
                                          f"{b}_expand_bn", swish))
                x = f"{b}_expand_activation"

            if s == 2:
                specs.append(G.zero_pad(f"{b}_dwconv_pad", x,
                                        C.correct_pad(size, kernel)))
                specs.append(_dwconv(
                    f"{b}_dwconv", f"{b}_dwconv_pad", filters,
                    (kernel, kernel), strides=(2, 2), padding="VALID"))
                size = C.stride2_out(size)
            else:
                specs.append(_dwconv(
                    f"{b}_dwconv", x, filters, (kernel, kernel),
                    padding="SAME"))
            specs.append(G.batch_norm(f"{b}_bn", f"{b}_dwconv", filters,
                                      **_BN))
            specs.append(G.activation(f"{b}_activation", f"{b}_bn", swish))
            x = f"{b}_activation"

            # Squeeze-and-excite; its width derives from the block's input
            # channels, as in Keras. GAP and Reshape are separate Keras
            # layers (index parity).
            se_filters = max(1, int(in_ch * se_ratio))
            specs.append(G.global_avg_pool(f"{b}_se_squeeze", x))
            specs.append(G.activation(f"{b}_se_reshape", f"{b}_se_squeeze",
                                      lambda t: t[:, :, None, None]))
            specs.append(_conv(f"{b}_se_reduce", f"{b}_se_reshape",
                                  filters, se_filters, (1, 1), act=swish))
            specs.append(_conv(f"{b}_se_expand", f"{b}_se_reduce",
                                  se_filters, filters, (1, 1),
                                  act=torch.sigmoid))
            specs.append(G.multiply(f"{b}_se_excite", x, f"{b}_se_expand"))

            specs.append(_conv(f"{b}_project_conv", f"{b}_se_excite",
                                  filters, filters_out, (1, 1),
                                  use_bias=False))
            specs.append(G.batch_norm(f"{b}_project_bn", f"{b}_project_conv",
                                      filters_out, **_BN))
            out = f"{b}_project_bn"
            if s == 1 and in_ch == filters_out:
                if drop_rate > 0:
                    # Stochastic depth: whole-sample drop (Keras Dropout
                    # with noise_shape (None, 1, 1, 1)).
                    specs.append(G.dropout(f"{b}_drop", out, drop_rate,
                                           broadcast_dims=(1, 2, 3)))
                    out = f"{b}_drop"
                specs.append(G.add(f"{b}_add", out, prev))
                out = f"{b}_add"
            prev, in_ch = out, filters_out
            block_num += 1

    top_filters = round_filters(1280, width)
    specs.append(_conv("top_conv", prev, in_ch, top_filters, (1, 1),
                          use_bias=False))
    specs.append(G.batch_norm("top_bn", "top_conv", top_filters, **_BN))
    specs.append(G.activation("top_activation", "top_bn", swish))
    return G.graph_of(*specs)


def build_efficientnet(variant: str, hparams: Dict[str, Any],
                       input_shape: Tuple[int, int, int], n_classes: int,
                       mixed_precision: bool = False,
                       output_bias: Optional[np.ndarray] = None
                       ) -> C.ModelSpec:
    """An EfficientNet variant (``EFFNET_PARAMS``) with the zoo's head."""
    backbone = efficientnet_backbone(variant, tuple(input_shape[:2]))
    graph, regs = C.classifier_head(backbone, n_classes=n_classes,
                                    dropout=float(hparams["DROPOUT"]),
                                    output_bias=output_bias)
    phases = C.single_phase(graph, int(hparams.get("FREEZE_IDX", -1)),
                            float(hparams["LR"]),
                            backbone_len=len(backbone.layers))
    return C.ModelSpec(name=f"efficientnet{variant}", graph=graph,
                       preprocess_mode="identity",
                       input_shape=tuple(input_shape), n_classes=n_classes,
                       dtype=C.compute_dtype(mixed_precision), phases=phases,
                       activity_regularizers=regs)


def build_efficientnetb7(hparams: Dict[str, Any],
                         input_shape: Tuple[int, int, int], n_classes: int,
                         mixed_precision: bool = False,
                         output_bias: Optional[np.ndarray] = None
                         ) -> C.ModelSpec:
    return build_efficientnet("b7", hparams, input_shape, n_classes,
                              mixed_precision, output_bias)
