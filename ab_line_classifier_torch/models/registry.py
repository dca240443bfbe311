"""Model registry — ``get_model(name)`` / ``build_model`` (port of
the JAX package's ``models/registry.py``).

Only the VGG16 family is ported so far. Every other zoo name raises
``NotImplementedError``: the JAX registry falls back to ``cnn0`` for an
unknown name, and here that fallback would silently build a model other
than the one asked for.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ab_line_classifier_torch.models.common import ModelSpec
from ab_line_classifier_torch.models.preprocess import get_preprocess_fn
from ab_line_classifier_torch.models.vgg import build_cutoffvgg16, build_vgg16

# name -> (builder, preprocess mode).
_REGISTRY: Dict[str, Tuple[Callable[..., ModelSpec], str]] = {
    "vgg16": (build_vgg16, "caffe"),
    "cutoffvgg16": (build_cutoffvgg16, "caffe"),
}

MODEL_NAMES = tuple(_REGISTRY)


def _entry(model_name: str) -> Tuple[Callable[..., ModelSpec], str]:
    name = model_name.lower()
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"model {model_name!r} is not ported to PyTorch yet (ported: "
            f"{MODEL_NAMES}); the rest of the zoo is ROADMAP Queue A item 8")
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
                output_bias: Optional[np.ndarray] = None) -> ModelSpec:
    builder, _ = _entry(model_name)
    return builder(hparams, tuple(input_shape), n_classes,
                   mixed_precision=mixed_precision, output_bias=output_bias)
