"""Shared model-zoo infrastructure (port of the JAX package's
``models/common.py``): :class:`ModelSpec`, the optimizer plan
(:class:`TrainPhase`, :func:`make_optimizer`, Keras Adam), the classifier
head and the stride-2 padding helpers.

The optimizer plan, as the JAX package's optax one:

* **Keras Adam** (:class:`KerasAdam`): eps is added to the square root of
  the *uncorrected* second moment, ``p -= lr * m * sqrt(1 - b2^t) / (1 -
  b1^t) / (sqrt(v) + eps)``; ``torch.optim.Adam`` adds it to that of the
  corrected one.
* **RMSprop**: rho 0.9, eps 1e-7 outside the square root (tf.keras 2.9,
  which the reference pins): ``torch.optim.RMSprop(alpha=0.9, eps=1e-7)``.
* **SGD**: ``p -= lr * g``.

A layer frozen in a phase (``TrainPhase.trainable`` False) is left out of
the optimizer and its parameters stop requiring grad: no update, no moment
buffers, and autograd records nothing that only it needs (optax's
``set_to_zero`` plus XLA's dead-code elimination). The learning rate lives
in the optimizer's ``param_groups``, where ReduceLROnPlateau scales it
(:func:`scale_learning_rate`).

:class:`StackedOptimizer` applies the same three rules to F trials'
parameters stacked along a leading axis, each tensor once for all trials,
with the JAX package's trial-parallel semantics: trial t's update is
scaled by ``lr_factor[t] * active[t]``, and an inactive trial's moments
and step count stay as they were.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ab_line_classifier_torch import graph as G


class KerasAdam(torch.optim.Optimizer):
    """Adam with Keras's epsilon placement (defaults b1 0.9, b2 0.999, eps
    1e-7). The bias correction is computed in float32, as the JAX
    package's optax transform computes it."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["m"] = torch.zeros_like(p)
                    state["v"] = torch.zeros_like(p)
                g, m, v = p.grad, state["m"], state["v"]
                state["step"] += 1
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                t = np.float32(state["step"])
                alpha = float(np.sqrt(np.float32(1) - np.float32(b2) ** t)
                              / (np.float32(1) - np.float32(b1) ** t))
                update = (m * alpha) / (v.sqrt() + eps)
                p.add_(update, alpha=-group["lr"])


@dataclasses.dataclass(frozen=True)
class TrainPhase:
    """One stage of the optimizer plan: ``optimizer`` ('adam' | 'rmsprop'
    | 'sgd') at learning rate ``lr`` for ``epochs`` epochs (None: all
    remaining); ``trainable`` maps each parameterized layer name to whether
    it trains in this phase."""

    name: str
    optimizer: str
    lr: float
    trainable: Dict[str, bool]
    epochs: Optional[int] = None


def _layer_of(param_name: str) -> str:
    """Layer name of a state-dict key (``block2_sepconv1.depthwise.weight``
    -> ``block2_sepconv1``)."""
    return param_name.split(".", 1)[0]


def make_optimizer(phase: TrainPhase, module: torch.nn.Module
                   ) -> torch.optim.Optimizer:
    """``phase``'s optimizer over ``module``'s trainable parameters; the
    frozen ones stop requiring grad and the trainable ones require it."""
    params: List[torch.nn.Parameter] = []
    for name, p in module.named_parameters():
        train = phase.trainable.get(_layer_of(name), True)
        p.requires_grad_(train)
        if train:
            params.append(p)
    if phase.optimizer == "adam":
        return KerasAdam(params, lr=phase.lr)
    if phase.optimizer == "rmsprop":
        return torch.optim.RMSprop(params, lr=phase.lr, alpha=0.9, eps=1e-7)
    if phase.optimizer == "sgd":
        return torch.optim.SGD(params, lr=phase.lr)
    raise ValueError(f"unknown optimizer {phase.optimizer!r}")


class StackedOptimizer:
    """``phase``'s optimizer over stacked trial parameters (name -> ``[F,
    ...]`` tensor, a leaf): the trainable ones (``TrainPhase.trainable``)
    require grad and get moments, the frozen ones stop requiring grad.

    :meth:`step` takes each trial's learning-rate factor and active flag
    (host arrays ``[F]``). Per element it computes what the one-trial
    optimizer computes (Keras Adam, RMSprop, SGD; the same operations in
    the same order), with the update multiplied by ``lr_factor * active``
    before the learning rate: for a trial at factor 1 the result is the
    one-trial optimizer's, and factor f is training at ``f * lr``, the
    updates being linear in the rate. Where ``active`` is 0 the trial's
    moments and step count keep their values (the parameters then move by
    ``0 * update``: not at all). Keras Adam's bias correction takes each
    trial's own step count, computed in float32 as :class:`KerasAdam`
    does."""

    def __init__(self, phase: TrainPhase, params: Dict[str, torch.Tensor],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7):
        if phase.optimizer not in ("adam", "rmsprop", "sgd"):
            raise ValueError(f"unknown optimizer {phase.optimizer!r}")
        self.kind, self.lr = phase.optimizer, float(phase.lr)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.rho = 0.9  # RMSprop's decay (tf.keras 2.9)
        self.names = []
        for name, p in params.items():
            train = phase.trainable.get(_layer_of(name), True)
            p.requires_grad_(train)
            if train:
                self.names.append(name)
        n_trials = next(iter(params.values())).shape[0]
        self.count = np.zeros(n_trials, np.int64)
        slots = {"adam": ("m", "v"), "rmsprop": ("sq",), "sgd": ()}
        self.state = {name: {k: torch.zeros_like(params[name])
                             for k in slots[self.kind]}
                      for name in self.names}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], lr_factor: np.ndarray,
             active: np.ndarray) -> None:
        """One update of every trainable parameter from its ``.grad``."""
        lr_factor = np.asarray(lr_factor, np.float32)
        active = np.asarray(active, np.float32)
        dev = params[self.names[0]].device if self.names else None
        gate = torch.as_tensor(lr_factor * active).to(dev)
        on = torch.as_tensor(active > 0).to(dev)
        if self.kind == "adam":
            t = (self.count + 1).astype(np.float32)
            alpha = (np.sqrt(np.float32(1) - np.float32(self.b2) ** t)
                     / (np.float32(1) - np.float32(self.b1) ** t))
            alpha = torch.as_tensor(alpha.astype(np.float32)).to(dev)
        for name in self.names:
            p, g, st = params[name], params[name].grad, self.state[name]
            if g is None:
                continue
            shape = (-1,) + (1,) * (p.ndim - 1)
            keep = on.view(shape)
            if self.kind == "adam":
                m = st["m"].mul(self.b1).add_(g, alpha=1.0 - self.b1)
                v = st["v"].mul(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                update = (m * alpha.view(shape)) / (v.sqrt() + self.eps)
                p.add_(update * gate.view(shape), alpha=-self.lr)
                st["m"].copy_(torch.where(keep, m, st["m"]))
                st["v"].copy_(torch.where(keep, v, st["v"]))
            elif self.kind == "rmsprop":
                sq = st["sq"].mul(self.rho).addcmul_(g, g,
                                                     value=1.0 - self.rho)
                avg = sq.sqrt().add_(self.eps)
                p.addcdiv_(g * gate.view(shape), avg, value=-self.lr)
                st["sq"].copy_(torch.where(keep, sq, st["sq"]))
            else:
                p.add_(g * gate.view(shape), alpha=-self.lr)
        self.count += (active > 0).astype(np.int64)

    def state_dict(self) -> Dict:
        return {"count": torch.as_tensor(self.count),
                "state": {n: dict(s) for n, s in self.state.items()}}

    def load_state_dict(self, sd: Dict) -> None:
        self.count = np.asarray(sd["count"], np.int64).copy()
        for name, slots in sd["state"].items():
            for k, v in slots.items():
                self.state[name][k].copy_(v)


def scale_learning_rate(optimizer: torch.optim.Optimizer,
                        factor: float) -> None:
    """Multiply the learning rate in place (ReduceLROnPlateau)."""
    for group in optimizer.param_groups:
        group["lr"] *= factor


def get_learning_rate(optimizer: torch.optim.Optimizer) -> Optional[float]:
    groups = optimizer.param_groups
    return float(groups[0]["lr"]) if groups else None


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A fully-specified zoo model. ``dtype`` is the compute dtype: bfloat16
    for a mixed-precision model, float32 otherwise (serving casts the
    module to it; training keeps float32 parameters and computes in it).
    ``phases`` is the optimizer plan; ``activity_regularizers`` maps a
    layer name to the L2 weight of its output in the loss."""

    name: str
    graph: G.LayerGraph
    preprocess_mode: str
    input_shape: Tuple[int, int, int]
    n_classes: int
    dtype: torch.dtype = torch.float32
    phases: Tuple[TrainPhase, ...] = ()
    activity_regularizers: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    logits_layer: str = "logits"

    def module(self, capture: Tuple[str, ...] = (),
               generator: Optional[torch.Generator] = None) -> G.GraphModule:
        """A freshly initialized (Keras initializers) float32 module on the
        CPU; ``generator`` seeds it (default: seed 0)."""
        return G.GraphModule(self.graph, capture=capture, generator=generator)

    def logits_module(self, capture: Tuple[str, ...] = (),
                      generator: Optional[torch.Generator] = None
                      ) -> G.GraphModule:
        """The module with the pre-softmax logits as its output (the loss
        is computed from them); its state dict is the full module's."""
        g = dataclasses.replace(self.graph, output=self.logits_layer)
        return G.GraphModule(g, capture=capture, generator=generator)

    def frozen_bn_layers(self, phase: TrainPhase) -> Tuple[str, ...]:
        """Batch norms frozen in ``phase``: they run in inference mode in
        training and never move their statistics (Keras trainable=False)."""
        return tuple(s.name for s in self.graph.layers
                     if s.kind == G.KIND_BN
                     and not phase.trainable.get(s.name, True))

    @property
    def last_conv_layer(self) -> str:
        """Last conv-like layer (the Grad-CAM tap)."""
        return self.graph.last_layer_of_kind(G.KIND_CONV, G.KIND_DEPTHWISE)


def compute_dtype(mixed_precision: bool) -> torch.dtype:
    return torch.bfloat16 if mixed_precision else torch.float32


def single_phase(graph: G.LayerGraph, freeze_idx: int, lr: float,
                 optimizer: str = "adam", freeze_bn: bool = True,
                 backbone_len: Optional[int] = None
                 ) -> Tuple[TrainPhase, ...]:
    """The one-phase plan of every model but cutoffvgg16: ``optimizer`` at
    ``lr`` with Keras ``freeze_layers`` trainability
    (:meth:`LayerGraph.trainable_mask`); ``freeze_bn`` False for the models
    whose reference model function never freezes (their batch norms train)."""
    return (TrainPhase(name="train", optimizer=optimizer, lr=lr,
                       trainable=graph.trainable_mask(
                           freeze_idx, freeze_bn_always=freeze_bn,
                           backbone_len=backbone_len)),)


def output_bias_init(output_bias: Optional[np.ndarray]
                     ) -> Optional[Callable[[torch.Tensor], None]]:
    """Keras ``bias_initializer=Constant(log_odds)`` equivalent: fills the
    final Dense bias in place."""
    if output_bias is None:
        return None
    arr = np.asarray(output_bias, dtype=np.float32)

    def init(bias: torch.Tensor) -> None:
        bias.copy_(torch.as_tensor(arr).expand(bias.shape))

    return init


def variance_scaling_(weight: torch.Tensor, generator: torch.Generator,
                      mode: str, distribution: str,
                      scale: float = 2.0) -> None:
    """``jax.nn.initializers.variance_scaling(scale, mode, distribution)``
    on a PyTorch ``[out, in, *kernel]`` weight: ``fan_in`` is ``in *
    receptive``, ``fan_out`` ``out * receptive``; ``uniform`` draws from
    ``±sqrt(3 * var)``, ``truncated_normal`` from a normal truncated at two
    standard deviations whose standard deviation is ``sqrt(var)``."""
    receptive = math.prod(weight.shape[2:])
    fan = (weight.shape[1] if mode == "fan_in" else weight.shape[0]) \
        * receptive
    var = scale / fan
    with torch.no_grad():
        if distribution == "uniform":
            limit = math.sqrt(3.0 * var)
            weight.uniform_(-limit, limit, generator=generator)
        elif distribution == "truncated_normal":
            # The std of a unit normal truncated to [-2, 2].
            std = math.sqrt(var) / 0.87962566103423978
            weight.normal_(0.0, 1.0, generator=generator)
            while True:
                bad = weight.abs() > 2.0
                if not bad.any():
                    break
                weight[bad] = torch.randn(int(bad.sum()),
                                          generator=generator)
            weight.mul_(std)
        else:
            raise ValueError(f"unknown distribution {distribution!r}")


def he_uniform(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Keras ``he_uniform`` (variance scaling 2, fan_in, uniform) on a conv
    or dense layer's weight."""
    variance_scaling_(module.weight, generator, "fan_in", "uniform")


def correct_pad(size: Tuple[int, int], kernel: int
                ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Keras ``imagenet_utils.correct_pad``: the zero padding before a
    stride-2 ``VALID`` conv that makes its output ``ceil(size / 2)``."""
    adjust = (1 - size[0] % 2, 1 - size[1] % 2)
    correct = kernel // 2
    return ((correct - adjust[0], correct), (correct - adjust[1], correct))


def stride2_out(size: Tuple[int, int]) -> Tuple[int, int]:
    """Spatial size after a correct_pad + stride-2 ``VALID`` conv (or a
    stride-2 ``SAME`` one): ``ceil(s / 2)`` for both parities."""
    return ((size[0] + 1) // 2, (size[1] + 1) // 2)


def classifier_head(backbone: G.LayerGraph, *, n_classes: int,
                    dropout: float,
                    output_bias: Optional[np.ndarray] = None,
                    fc0_nodes: Optional[int] = None,
                    fc0_l2: float = 0.0,
                    fc0_init: Optional[Callable] = None,
                    double_dropout: bool = False
                    ) -> Tuple[G.LayerGraph, Dict[str, float]]:
    """Append the standard head: GAP -> Dropout [-> Dense(fc0_nodes) with a
    fused relu (one node, as Keras ``Dense(activation='relu')``) (->
    Dropout)] -> Dense(n_classes) -> float32 softmax. Returns the graph and
    the activity-regularizer map (``fc0`` at ``fc0_l2`` when both are set);
    ``fc0_init(module, generator)`` replaces fc0's glorot-uniform kernel."""
    src = backbone.output
    specs: List[G.LayerSpec] = [
        G.global_avg_pool("global_avgpool", src),
        G.dropout("dropout_head", "global_avgpool", dropout)]
    prev, width = "dropout_head", backbone.features_of(src)
    regs: Dict[str, float] = {}
    if fc0_nodes:
        spec = G.dense("fc0", prev, width, fc0_nodes, act=F.relu)
        if fc0_init is not None:
            spec = G.with_init(spec, fc0_init)
        specs.append(spec)
        if fc0_l2:
            regs["fc0"] = fc0_l2
        prev, width = "fc0", fc0_nodes
        if double_dropout:
            specs.append(G.dropout("dropout_head1", prev, dropout))
            prev = "dropout_head1"
    specs += [G.dense("logits", prev, width, n_classes,
                      bias_init=output_bias_init(output_bias)),
              G.softmax("output", "logits")]
    return backbone.append(specs, output="output"), regs
