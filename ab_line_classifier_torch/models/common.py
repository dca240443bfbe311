"""Shared model-zoo infrastructure (port of the JAX package's
``models/common.py``): :class:`ModelSpec`, the optimizer plan
(:class:`TrainPhase`, :func:`make_optimizer`, Keras Adam), the classifier
head and the stride-2 padding helpers.

The optimizer plan, as the JAX package's optax one:

* **Keras Adam** (:class:`KerasAdam`): eps is added to the square root of
  the *uncorrected* second moment, ``p -= lr * m * sqrt(1 - b2^t) / (1 -
  b1^t) / (sqrt(v) + eps)``; ``torch.optim.Adam`` adds it to that of the
  corrected one.
* **RMSprop** (:class:`RMSprop`): rho 0.9, eps 1e-7 outside the square
  root (tf.keras 2.9, which the reference pins).
* **SGD** (:class:`SGD`): ``p -= lr * g``.

A layer frozen in a phase (``TrainPhase.trainable`` False) is left out of
the optimizer and its parameters stop requiring grad: no update, no moment
buffers, and autograd records nothing that only it needs (optax's
``set_to_zero`` plus XLA's dead-code elimination). The learning rate lives
in the optimizer's ``param_groups``, where ReduceLROnPlateau scales it
(:func:`scale_learning_rate`), and in a device tensor beside it that the
update reads (:class:`DeviceLROptimizer`); the step counts and Adam's bias
correction (a table of its float32 host values, :func:`adam_alpha_table`)
are read on the device too. So an optimizer step does no host work that a
CUDA graph would freeze (``train/graphed.py``): optax's state, which the
JAX package's scanned epoch carries, is device state here as well.

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


#: Keras Adam's bias correction ``alpha(t)`` by step, per ``(b1, b2)``.
_ALPHA_TABLES: Dict[Tuple[float, float], np.ndarray] = {}
_ALPHA_DEVICE: Dict[Tuple[float, float, torch.device], torch.Tensor] = {}


def adam_alpha_table(b1: float = 0.9, b2: float = 0.999) -> np.ndarray:
    """Keras Adam's bias correction ``sqrt(1 - b2^t) / (1 - b1^t)`` for t
    = 0, 1, ..., T - 1 (entry 0 unused), each computed on the host in
    numpy float32 scalars, as the one-step formula always computed it;
    from T on both powers have rounded ``1 - b^t`` to 1, and every later
    step's value is the last entry, 1.0 (:func:`adam_alpha` clamps the
    step there). T is 17322 at the defaults."""
    key = (float(b1), float(b2))
    table = _ALPHA_TABLES.get(key)
    if table is None:
        one, fb1, fb2 = np.float32(1), np.float32(b1), np.float32(b2)
        vals = [np.float32(0)]
        t = 0
        while True:
            t += 1
            ft = np.float32(t)
            p1, p2 = fb1 ** ft, fb2 ** ft
            vals.append(np.float32(np.sqrt(one - p2) / (one - p1)))
            if one - p1 == one and one - p2 == one:
                break
        table = np.asarray(vals, np.float32)
        _ALPHA_TABLES[key] = table
    return table


def adam_alpha(step: torch.Tensor, b1: float, b2: float) -> torch.Tensor:
    """``alpha(step)`` of :func:`adam_alpha_table`, read on ``step``'s
    device from the table kept there (uploaded once per device), for an
    integer ``step`` tensor of any shape: a gather, no host value, so a
    captured step reads each replay's own count."""
    key = (float(b1), float(b2), step.device)
    table = _ALPHA_DEVICE.get(key)
    if table is None:
        table = torch.as_tensor(adam_alpha_table(b1, b2)).to(step.device)
        _ALPHA_DEVICE[key] = table
    flat = step.reshape(-1).clamp(max=table.shape[0] - 1)
    return table.index_select(0, flat).view(step.shape)


class DeviceLROptimizer(torch.optim.Optimizer):
    """An optimizer whose learning rate the update reads from the device.

    ``param_groups`` keep each group's rate as a float, which
    :func:`get_learning_rate`, :func:`scale_learning_rate` and the resume
    files read; :meth:`sync_lr` mirrors each group's negated rate into a
    float32 device tensor (``float32(-lr)``, what an ``alpha=-lr`` scalar
    argument became), and the update multiplies by that tensor. A step
    captured in a CUDA graph then follows a ReduceLROnPlateau cut with no
    recapture. The step counts live on the device too."""

    def __init__(self, params, defaults):
        super().__init__(params, defaults)
        self._neg_lr = [
            torch.zeros((), dtype=torch.float32,
                        device=(g["params"][0].device if g["params"]
                                else None))
            for g in self.param_groups]
        self.sync_lr()

    @torch.no_grad()
    def sync_lr(self) -> None:
        """Copy each group's float rate into its device tensor."""
        for t, group in zip(self._neg_lr, self.param_groups):
            t.fill_(-float(group["lr"]))

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for p, state in self.state.items():
            if "step" in state:  # a count saved as an int or on the host
                state["step"] = torch.as_tensor(
                    state["step"], dtype=torch.int64).to(p.device)
        self.sync_lr()

    def _state(self, p: torch.Tensor, *slots: str) -> Dict:
        """``p``'s state, made on its first step: a device step count and
        zeroed ``slots``."""
        state = self.state[p]
        if not state:
            state["step"] = torch.zeros((), dtype=torch.int64,
                                        device=p.device)
            for k in slots:
                state[k] = torch.zeros_like(p)
        return state


class KerasAdam(DeviceLROptimizer):
    """Adam with Keras's epsilon placement (defaults b1 0.9, b2 0.999, eps
    1e-7). The bias correction is the float32 host value of the JAX
    package's optax transform, read by step from a table on the device
    (:func:`adam_alpha`)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group, neg_lr in zip(self.param_groups, self._neg_lr):
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self._state(p, "m", "v")
                g, m, v = p.grad, state["m"], state["v"]
                state["step"] += 1
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                alpha = adam_alpha(state["step"], b1, b2)
                update = (m * alpha) / (v.sqrt() + eps)
                p.addcmul_(update, neg_lr)


class RMSprop(DeviceLROptimizer):
    """RMSprop with tf.keras 2.9's rho 0.9 and eps 1e-7 outside the square
    root, ``torch.optim.RMSprop(alpha=0.9, eps=1e-7)``'s arithmetic with
    the rate on the device: ``square_avg = alpha * square_avg + (1 -
    alpha) * g^2``, ``p += (g * -lr) / (sqrt(square_avg) + eps)``. The
    decay keeps torch's name, ``alpha``, and the state torch's keys, so a
    ``torch.optim.RMSprop`` state dict loads and steps on."""

    def __init__(self, params, lr: float, alpha: float = 0.9,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group, neg_lr in zip(self.param_groups, self._neg_lr):
            rho, eps = group["alpha"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self._state(p, "square_avg")
                g, sq = p.grad, state["square_avg"]
                state["step"] += 1
                sq.mul_(rho).addcmul_(g, g, value=1.0 - rho)
                p.addcdiv_(g * neg_lr, sq.sqrt().add_(eps))


class SGD(DeviceLROptimizer):
    """Plain SGD, ``p += g * -lr``, the rate on the device."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        for group, neg_lr in zip(self.param_groups, self._neg_lr):
            for p in group["params"]:
                if p.grad is not None:
                    p.addcmul_(p.grad, neg_lr)


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
        return RMSprop(params, lr=phase.lr)
    if phase.optimizer == "sgd":
        return SGD(params, lr=phase.lr)
    raise ValueError(f"unknown optimizer {phase.optimizer!r}")


def trial_vector(x, device) -> torch.Tensor:
    """A per-trial ``[F]`` vector (a host array or a tensor) as float32 on
    ``device``: the same values either way."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32)).to(device)


class StackedOptimizer:
    """``phase``'s optimizer over stacked trial parameters (name -> ``[F,
    ...]`` tensor, a leaf): the trainable ones (``TrainPhase.trainable``)
    require grad and get moments, the frozen ones stop requiring grad.

    :meth:`step` takes each trial's learning-rate factor and active flag
    (``[F]``, host arrays or float32 device tensors). Per element it
    computes what the one-trial optimizer computes (Keras Adam, RMSprop,
    SGD; the same operations in the same order), with the rate ``-lr``
    multiplied by ``lr_factor * active`` first: for a trial at factor 1
    the result is the one-trial optimizer's, bit for bit, and factor f is
    training at ``f * lr``, the updates being linear in the rate. Where
    ``active`` is 0 the trial's moments and step count keep their values
    (the parameters then move by ``0 * update``: not at all). Keras Adam's
    bias correction takes each trial's own step count (:func:`adam_alpha`).
    The counts live on the device (:attr:`count` reads them back), and
    ``lr`` is the phase's constant, so a step does no host work."""

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
        first = next(iter(params.values()))
        self._count = torch.zeros(first.shape[0], dtype=torch.int64,
                                  device=first.device)
        self._neg_lr = torch.full((), -self.lr, dtype=torch.float32,
                                  device=first.device)
        slots = {"adam": ("m", "v"), "rmsprop": ("sq",), "sgd": ()}
        self.state = {name: {k: torch.zeros_like(params[name])
                             for k in slots[self.kind]}
                      for name in self.names}

    @property
    def count(self) -> np.ndarray:
        """Each trial's step count (a host copy)."""
        return self._count.cpu().numpy()

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], lr_factor,
             active) -> None:
        """One update of every trainable parameter from its ``.grad``."""
        dev = self._count.device
        active = trial_vector(active, dev)
        on = active > 0
        rate = trial_vector(lr_factor, dev) * active * self._neg_lr
        if self.kind == "adam":
            alpha = adam_alpha(self._count + 1, self.b1, self.b2)
        for name in self.names:
            p, g, st = params[name], params[name].grad, self.state[name]
            if g is None:
                continue
            shape = (-1,) + (1,) * (p.ndim - 1)
            keep = on.view(shape)
            scale = rate.view(shape)
            if self.kind == "adam":
                m = st["m"].mul(self.b1).add_(g, alpha=1.0 - self.b1)
                v = st["v"].mul(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                update = (m * alpha.view(shape)) / (v.sqrt() + self.eps)
                p.addcmul_(update, scale)
                st["m"].copy_(torch.where(keep, m, st["m"]))
                st["v"].copy_(torch.where(keep, v, st["v"]))
            elif self.kind == "rmsprop":
                sq = st["sq"].mul(self.rho).addcmul_(g, g,
                                                     value=1.0 - self.rho)
                p.addcdiv_(g * scale, sq.sqrt().add_(self.eps))
                st["sq"].copy_(torch.where(keep, sq, st["sq"]))
            else:
                p.addcmul_(g, scale)
        self._count += on.to(torch.int64)

    def state_dict(self) -> Dict:
        return {"count": torch.as_tensor(self.count),
                "state": {n: dict(s) for n, s in self.state.items()}}

    def load_state_dict(self, sd: Dict) -> None:
        self._count.copy_(torch.as_tensor(
            np.asarray(sd["count"], np.int64)))
        for name, slots in sd["state"].items():
            for k, v in slots.items():
                self.state[name][k].copy_(v)


def scale_learning_rate(optimizer: DeviceLROptimizer,
                        factor: float) -> None:
    """Multiply the learning rate in place (ReduceLROnPlateau), on the
    host and on the device."""
    for group in optimizer.param_groups:
        group["lr"] *= factor
    optimizer.sync_lr()


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

    def layer_shapes(self, state_dict: Optional[Dict[str, torch.Tensor]]
                     = None) -> Dict[str, Tuple[int, ...]]:
        """Every layer's output shape, and the input node's, as the module
        gives it (NHWC for 4-D activations) at batch 1: one float32 forward
        of zeros on the CPU, with ``state_dict`` when given (the shapes do
        not depend on it)."""
        names = tuple(self.graph.layer_names[1:])
        module = self.module(capture=names)
        if state_dict is not None:
            module.load_state_dict(state_dict)
        with torch.inference_mode():
            _, acts = module.eval()(torch.zeros((1,) + self.input_shape))
        shapes = {n: tuple(a.shape) for n, a in acts.items()}
        shapes[G.INPUT] = (1,) + tuple(self.input_shape)
        return shapes

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
