"""The project's training step, plainly.

An epoch's order: ``RandomState(seed)``'s shuffle of the rows. A step: its
batch of that order, augmented, scaled to the model's input, a forward in
training mode (dropout drawn from the step's second generator), the loss,
the gradients of the phase's trainable layers, one optimizer update.

Loss per example: categorical cross-entropy of the float32 logits,
weighted by the example's class weight in training and not in validation,
plus ``lambda * sum(a^2)`` of each activity-regularized layer's output;
the batch's mean.

Each step's two generators (augmentation, dropout) are seeded with the two
64-bit words of ``numpy.random.SeedSequence([seed, phase, step])``.

Optimizers (tf.keras 2.9): RMSprop, ``s = 0.9 s + 0.1 g^2``, ``p -= lr g /
(sqrt(s) + 1e-7)``; Adam, ``m = 0.9 m + 0.1 g``, ``v = 0.999 v + 0.001
g^2``, ``p -= lr m sqrt(1 - 0.999^t) / (1 - 0.9^t) / (sqrt(v) + 1e-7)``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from reference.augment import augment
from reference.preprocess import scale_input


def step_seeds(seed: int, phase: int, step: int):
    words = np.random.SeedSequence([seed, phase, step]).generate_state(
        2, np.uint64)
    return int(words[0]), int(words[1])


def shuffled(n: int, seed: int) -> np.ndarray:
    """The rows of an epoch of ``n`` shuffled by ``seed``, in order."""
    order = np.arange(n, dtype=np.int64)
    np.random.RandomState(seed).shuffle(order)
    return order


def example_losses(model, config: dict, x: torch.Tensor,
                   labels: torch.Tensor, class_weight, generator=None
                   ) -> torch.Tensor:
    """Per-example loss of model input ``x``; ``generator`` set in
    training (dropout draws, class weights)."""
    logits, caps = model(x, generator=generator)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    per = -logp.gather(1, labels.long().view(-1, 1))[:, 0]
    if generator is not None:
        per = per * class_weight[labels.long()]
    for name, lam in config.get("activity_l2", {}).items():
        a = caps[name].to(torch.float32)
        per = per + lam * (a * a).sum(1)
    return per


class Optimizer:
    """``slots`` and ``t``, when given, are the state to go on from: each
    parameter's ``[square average, unused]`` (RMSprop) or ``[first moment,
    second moment]`` (Adam), and the steps taken."""

    def __init__(self, kind: str, lr: float,
                 params: Dict[str, torch.Tensor],
                 slots: Optional[Dict[str, List[torch.Tensor]]] = None,
                 t: int = 0):
        if kind not in ("rmsprop", "adam"):
            raise ValueError(f"unknown optimizer {kind!r}")
        self.kind, self.lr, self.t = kind, lr, t
        self.slots = ({n: [s.clone() for s in slots[n]] for n in params}
                      if slots is not None else
                      {n: [torch.zeros_like(p), torch.zeros_like(p)]
                       for n, p in params.items()})

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        for n, g in grads.items():
            s = self.slots[n]
            if self.kind == "rmsprop":
                s[0].mul_(0.9).add_(0.1 * g * g)
                params[n].sub_(self.lr * g / (s[0].sqrt() + 1e-7))
            else:
                s[0].mul_(0.9).add_(0.1 * g)
                s[1].mul_(0.999).add_(0.001 * g * g)
                alpha = (math.sqrt(1.0 - 0.999 ** self.t)
                         / (1.0 - 0.9 ** self.t))
                params[n].sub_(self.lr * alpha * s[0]
                               / (s[1].sqrt() + 1e-7))


def trainable_params(model, config: dict) -> Dict[str, torch.nn.Parameter]:
    """The phase's trainable parameters by state-dict name; every other
    parameter stops requiring grad."""
    layers = set(config["train_phase"]["trainable"])
    out = {}
    for name, p in model.named_parameters():
        train = name.split(".", 1)[0] in layers
        p.requires_grad_(train)
        if train:
            out[name] = p
    return out


def train_steps(model, config: dict, aug: dict, seed: int,
                batches: Sequence, class_weight: torch.Tensor,
                first_step: int = 0, slots=None, t: int = 0) -> dict:
    """The phase's steps from ``model``'s weights, one per ``(uint8
    images, labels)`` batch in the epoch's order, the first being the
    phase's step ``first_step`` (its generators' seeds), the optimizer
    going on from ``slots`` and ``t`` (:class:`Optimizer`) when given.
    Returns each step's loss, the first step's gradient by parameter and
    the trainable parameters after the last."""
    phase = config["train_phase"]
    params = trainable_params(model, config)
    opt = Optimizer(phase["optimizer"], float(phase["lr"]), params, slots, t)
    losses: List[float] = []
    first = None
    for step, (images, labels) in enumerate(batches, first_step):
        s_aug, s_drop = step_seeds(seed, phase["index"], step)
        dev = images.device
        g_aug = torch.Generator(device=dev).manual_seed(s_aug)
        g_drop = torch.Generator(device=dev).manual_seed(s_drop)
        x = scale_input(augment(images, g_aug, aug),
                        config["preprocess_mode"])
        loss = example_losses(model, config, x, labels, class_weight,
                              g_drop).mean()
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        opt.step(params, grads)
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first,
            "params": {n: p.detach().clone() for n, p in params.items()}}
