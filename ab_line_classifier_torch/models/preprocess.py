"""Per-model input scaling functions (port of
the JAX package's ``models/preprocess.py``).

Each architecture pairs with a Keras ``preprocess_input`` mode; all take a
float tensor of RGB values in [0, 255] (NHWC) and return the model-ready
tensor:

* ``caffe``  — VGG16: RGB->BGR channel swap, subtract ImageNet BGR means.
* ``tf``     — MobileNetV2 / Xception / ResNetV2: scale to [-1, 1].
* ``scale``  — plain ``x / 255``.
* ``identity`` — EfficientNet: passthrough (normalization is in the model).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

# ImageNet channel means in BGR order (keras 'caffe' mode).
CAFFE_MEAN_BGR = np.array([103.939, 116.779, 123.68], dtype=np.float32)
# The means as a tensor, per (dtype, device): made once, so a training step
# copies nothing from the host (a CUDA graph's capture cannot).
_CAFFE_MEANS: Dict = {}


def preprocess_caffe(x: torch.Tensor) -> torch.Tensor:
    """VGG16 preprocessing: RGB->BGR and zero-center by ImageNet BGR means."""
    x = x.flip(-1)
    key = (x.dtype, x.device)
    mean = _CAFFE_MEANS.get(key)
    if mean is None:
        mean = torch.as_tensor(CAFFE_MEAN_BGR, dtype=x.dtype).to(x.device)
        _CAFFE_MEANS[key] = mean
    return x - mean


def preprocess_tf(x: torch.Tensor) -> torch.Tensor:
    """Scale to [-1, 1]."""
    return x / 127.5 - 1.0


def preprocess_scale(x: torch.Tensor) -> torch.Tensor:
    """Default pipeline scaling ``x / 255``."""
    return x / 255.0


def preprocess_identity(x: torch.Tensor) -> torch.Tensor:
    """EfficientNet: passthrough (normalization is inside the model)."""
    return x


PREPROCESS_FNS: Dict[str, Callable] = {
    "caffe": preprocess_caffe,
    "tf": preprocess_tf,
    "scale": preprocess_scale,
    "identity": preprocess_identity,
}


def get_preprocess_fn(mode: str) -> Callable:
    try:
        return PREPROCESS_FNS[mode]
    except KeyError as e:
        raise ValueError(f"unknown preprocess mode {mode!r}") from e


def preprocess_affine_params(mode: str):
    """Return ``(channel_perm[3], scale[3], bias[3])`` so that
    ``out[..., c] = x[..., perm[c]] * scale[c] + bias[c]`` equals the mode's
    preprocessing. All modes in the zoo are channelwise-affine."""
    if mode == "caffe":
        return (np.array([2, 1, 0]), np.ones(3, np.float32),
                -CAFFE_MEAN_BGR)
    if mode == "tf":
        return (np.arange(3), np.full(3, 1.0 / 127.5, np.float32),
                np.full(3, -1.0, np.float32))
    if mode == "scale":
        return (np.arange(3), np.full(3, 1.0 / 255.0, np.float32),
                np.zeros(3, np.float32))
    if mode == "identity":
        return (np.arange(3), np.ones(3, np.float32), np.zeros(3, np.float32))
    raise ValueError(f"unknown preprocess mode {mode!r}")
