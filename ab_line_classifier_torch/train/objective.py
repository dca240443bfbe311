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

Stacked trials (``parallel/trial_parallel.py``): :func:`forward_loss` runs
under ``torch.func.vmap``, each trial with its own class weights ``[C]``
(of the stacked ``[F, C]``) and mask; the images of all F trials go
through the augmentation and the affine, or through B1, as one
``[F * B]`` batch (:func:`prepare_stacked_images`,
:func:`eval_stacked_images`), each trial's augmentation drawn from its
own generator (:func:`stacked_parts`).

Data parallelism: a rank's batch is its rows of the global batch. The
loss then divides the rank's masked sum by the GLOBAL batch's denominator
(``denom``), as the JAX package's one program does, and the ranks' summed
gradients are the global loss's; augmentation parts are drawn for the
global batch and the rank's rows kept (``shard``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ab_line_classifier_torch.data.augment import (Parts, apply_parts,
                                                  augment_batch, sample_parts,
                                                  shard_parts)
from ab_line_classifier_torch.models.common import ModelSpec
from ab_line_classifier_torch.ops.preprocess_cuda import preprocess_frames


def forward_loss(module: torch.nn.Module, reg_layers: Sequence[str],
                 reg_lambdas: Sequence[float], x: torch.Tensor,
                 labels_oh: torch.Tensor, mask: torch.Tensor,
                 class_w: torch.Tensor, train: bool,
                 generator: Optional[torch.Generator] = None,
                 denom=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward of ``module`` (a logits module capturing
    ``reg_layers``; its training mode set by the caller) and the loss.
    Returns ``(loss, probs, per_example_total)``; ``class_w`` ``[C]``
    weights the training loss only. ``denom`` is the loss's denominator
    (default ``max(sum(mask), 1)``; the global batch's under data
    parallelism)."""
    out = module(x, generator=generator)
    logits, caps = out if reg_layers else (out, {})
    logits = logits.to(torch.float32)
    per_ex = -(labels_oh * F.log_softmax(logits, dim=-1)).sum(-1)
    if train:
        per_ex = per_ex * (labels_oh * class_w).sum(-1)
    for name, lam in zip(reg_layers, reg_lambdas):
        a = caps[name].to(torch.float32)
        per_ex = per_ex + lam * (a * a).sum(dim=tuple(range(1, a.ndim)))
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1.0)
    loss = (per_ex * mask).sum() / denom
    return loss, torch.softmax(logits, dim=-1), per_ex


def prepare_images(preprocess_fn: Callable, aug_params: Optional[Dict],
                   compute_dtype: torch.dtype, images: torch.Tensor,
                   generator: Optional[torch.Generator],
                   shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """A uint8 training batch -> augmented (when ``aug_params``) and
    normalized model input in ``compute_dtype`` (the reference's
    augment-then-scale order); ``shard`` as :func:`augment_batch`'s."""
    x = images.to(torch.float32)
    if aug_params:
        x = augment_batch(x, generator, shard=shard, **aug_params)
    return preprocess_fn(x).to(compute_dtype)


def eval_images(spec: ModelSpec, images: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
    """A uint8 evaluation batch -> model input in ``compute_dtype`` through
    ``preprocess_frames`` (kernel B1 on CUDA)."""
    return preprocess_frames(images, out_hw=tuple(spec.input_shape[:2]),
                             preprocess_mode=spec.preprocess_mode,
                             out_dtype=compute_dtype)


def stacked_parts(generators: Sequence[torch.Generator], batch: int,
                  hw: Tuple[int, int], device: torch.device,
                  aug_params: Dict, shard: Tuple[int, int] = (0, 1)) -> Parts:
    """The augmentation parts of F trials' batches, trial t's drawn from
    ``generators[t]`` (CPU generators: the draws are made on the host and
    go over in one copy per part), concatenated to ``[F * batch]``; with
    ``shard`` each trial's batch is that shard of its global batch."""
    parts = [sample_parts(g, batch * shard[1], hw, torch.device("cpu"),
                          **aug_params) for g in generators]
    if shard[1] > 1:
        parts = [shard_parts(p, shard) for p in parts]
    return Parts(*(torch.cat(p).to(device) for p in zip(*parts)))


def prepare_stacked_images(preprocess_fn: Callable, aug_params: Optional[Dict],
                           compute_dtype: torch.dtype, images: torch.Tensor,
                           parts: Optional[Parts]) -> torch.Tensor:
    """:func:`prepare_images` of a stacked uint8 batch ``[F, B, H, W, 3]``
    as one ``[F * B]`` batch, augmented by ``parts`` (from
    :func:`stacked_parts`) when ``aug_params`` is set."""
    f, b = images.shape[:2]
    x = images.reshape((f * b,) + tuple(images.shape[2:])).to(torch.float32)
    if aug_params:
        x = apply_parts(x, parts, zoom=aug_params.get("zoom", 0.0),
                        rotation=aug_params.get("rotation", 0.0),
                        brightness=aug_params.get("brightness", 0.0))
    return preprocess_fn(x).to(compute_dtype).view(images.shape)


def eval_stacked_images(spec: ModelSpec, images: torch.Tensor,
                        compute_dtype: torch.dtype) -> torch.Tensor:
    """:func:`eval_images` of a stacked uint8 batch ``[F, B, H, W, 3]``:
    one B1 launch over the ``F * B`` frames."""
    f, b = images.shape[:2]
    x = eval_images(spec, images.reshape((f * b,) + tuple(images.shape[2:])),
                    compute_dtype)
    return x.view((f, b) + tuple(x.shape[1:]))
