"""The training objective (port of the JAX package's ``train/objective.py``):
the forward pass and Keras's loss.

* masked categorical cross-entropy on float32 logits, weighted by class
  in training and **unweighted** in validation (Keras ``fit(class_weight
  =...)``);
* plus each activity regularizer's penalty, ``lambda * sum(a^2)`` of the
  layer's captured (post-activation) output, per example, in both;
* the mean over the batch's valid rows, ``max(sum(mask), 1)``.

Images: a training batch goes uint8 -> float32 -> augmentation -> the
model's affine (:func:`prepare_images`; the augmentation works on floats,
so kernel B1, which takes uint8, cannot serve here); an evaluation batch
has no augmentation and goes uint8 -> B1 on CUDA (its plain version on the
CPU) in one pass (:func:`eval_images`), the kernel the serving path runs.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ab_line_classifier_torch.data.augment import augment_batch
from ab_line_classifier_torch.models.common import ModelSpec
from ab_line_classifier_torch.ops.preprocess_cuda import preprocess_frames


def forward_loss(module: torch.nn.Module, reg_layers: Sequence[str],
                 reg_lambdas: Sequence[float], x: torch.Tensor,
                 labels_oh: torch.Tensor, mask: torch.Tensor,
                 class_w: torch.Tensor, train: bool,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward of ``module`` (a logits module capturing
    ``reg_layers``; its training mode set by the caller) and the loss.
    Returns ``(loss, probs, per_example_total)``; ``class_w`` ``[C]``
    weights the training loss only."""
    out = module(x, generator=generator)
    logits, caps = out if reg_layers else (out, {})
    logits = logits.to(torch.float32)
    per_ex = -(labels_oh * F.log_softmax(logits, dim=-1)).sum(-1)
    if train:
        per_ex = per_ex * (labels_oh * class_w).sum(-1)
    for name, lam in zip(reg_layers, reg_lambdas):
        a = caps[name].to(torch.float32)
        per_ex = per_ex + lam * (a * a).sum(dim=tuple(range(1, a.ndim)))
    loss = (per_ex * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, torch.softmax(logits, dim=-1), per_ex


def prepare_images(preprocess_fn: Callable, aug_params: Optional[Dict],
                   compute_dtype: torch.dtype, images: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """A uint8 training batch -> augmented (when ``aug_params``) and
    normalized model input in ``compute_dtype`` (the reference's
    augment-then-scale order)."""
    x = images.to(torch.float32)
    if aug_params:
        x = augment_batch(x, generator, **aug_params)
    return preprocess_fn(x).to(compute_dtype)


def eval_images(spec: ModelSpec, images: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
    """A uint8 evaluation batch -> model input in ``compute_dtype`` through
    ``preprocess_frames`` (kernel B1 on CUDA)."""
    return preprocess_frames(images, out_hw=tuple(spec.input_shape[:2]),
                             preprocess_mode=spec.preprocess_mode,
                             out_dtype=compute_dtype)
