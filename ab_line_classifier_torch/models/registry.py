"""Model registry — ``get_model(name)`` / ``build_model`` (port of
the JAX package's ``models/registry.py``).

Every model of the zoo is ported. An unknown name raises
``NotImplementedError``: the JAX registry falls back to ``cnn0`` for an
unknown name, and here that fallback would silently build a model other
than the one asked for.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ab_line_classifier_torch.models.cnn0 import build_cnn0
from ab_line_classifier_torch.models.common import ModelSpec
from ab_line_classifier_torch.models.efficientnet import build_efficientnetb7
from ab_line_classifier_torch.models.mobilenet_v2 import build_mobilenetv2
from ab_line_classifier_torch.models.preprocess import get_preprocess_fn
from ab_line_classifier_torch.models.resnet_v2 import build_custom_resnetv2
from ab_line_classifier_torch.models.vgg import build_cutoffvgg16, build_vgg16
from ab_line_classifier_torch.models.xception import build_xception

# name -> (builder, preprocess mode).
_REGISTRY: Dict[str, Tuple[Callable[..., ModelSpec], str]] = {
    "vgg16": (build_vgg16, "caffe"),
    "cutoffvgg16": (build_cutoffvgg16, "caffe"),
    "mobilenetv2": (build_mobilenetv2, "tf"),
    "xception": (build_xception, "tf"),
    "efficientnetb7": (build_efficientnetb7, "identity"),
    "custom_resnetv2": (build_custom_resnetv2, "tf"),
    "cnn0": (build_cnn0, "tf"),
}

MODEL_NAMES = tuple(_REGISTRY)


def _entry(model_name: str) -> Tuple[Callable[..., ModelSpec], str]:
    name = model_name.lower()
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"no model {model_name!r} in the zoo (models: {MODEL_NAMES}); "
            f"the port does not fall back to another model")
    return _REGISTRY[name]


def get_model(model_name: str) -> Tuple[Callable[..., ModelSpec], Callable]:
    """Return ``(builder, preprocess_fn)`` for a model name."""
    builder, mode = _entry(model_name)
    return builder, get_preprocess_fn(mode)


def get_preprocess_mode(model_name: str) -> str:
    return _entry(model_name)[1]


def build_model(model_name: str, hparams: Dict[str, Any],
                input_shape: Tuple[int, int, int], n_classes: int,
                mixed_precision: bool = False,
                output_bias: Optional[np.ndarray] = None,
                total_epochs: Optional[int] = None) -> ModelSpec:
    """``total_epochs`` (TRAIN.EPOCHS) sizes cutoffvgg16's finetune phase;
    the one-phase models run until the fit's epoch budget is spent."""
    builder, _ = _entry(model_name)
    kwargs = ({"total_epochs": total_epochs}
              if builder is build_cutoffvgg16 else {})
    return builder(hparams, tuple(input_shape), n_classes,
                   mixed_precision=mixed_precision, output_bias=output_bias,
                   **kwargs)
