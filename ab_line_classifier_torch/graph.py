"""Layer-graph IR (port of the JAX package's ``graph.py``).

Models are an explicit DAG of named :class:`LayerSpec` nodes in Keras
topological order (node 0 is the input, matching ``keras.Model.layers``
numbering), so the reference's index-based operations keep their meaning:

* :meth:`LayerGraph.cut` — truncate at a layer index/name (CUTOFF_IDX).
* :meth:`LayerGraph.trainable_mask` — per-layer trainability (FREEZE_IDX).
* :meth:`LayerGraph.last_layer_of_kind` — e.g. the Grad-CAM conv tap.
* :class:`GraphModule` — an ``nn.Module`` executing the DAG, with
  ``capture`` (return named intermediate activations from the same pass)
  and ``overrides`` (inject an activation by layer name), which Grad-CAM
  and attribution build on.

Parameterized layers are submodules named by their Keras layer name, so the
state-dict keys read ``block1_conv1.weight``. Layouts: the module's public
tensors are NHWC, as in the JAX package; inside, 4-D activations are NCHW
views of NHWC memory (``channels_last``), the layout cuDNN wants.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

INPUT = "__input__"

# Layer kinds with special call conventions or freeze semantics.
KIND_CONV = "conv"
KIND_DEPTHWISE = "depthwise"
KIND_BN = "bn"
KIND_DENSE = "dense"
KIND_DROPOUT = "dropout"
KIND_FN = "fn"  # pure function of its inputs (activation, pool, add, pad...)
KIND_NORM = "norm"

_NOT_YET = "waits for the zoo slice of the port (ROADMAP Queue A item 8)"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One node of the model DAG.

    Exactly one of ``module_fn`` / ``fn`` is set. ``module_fn`` takes a
    ``torch.Generator`` and returns the layer's initialized ``nn.Module``;
    ``fn`` is a pure function of the input activations. ``post_fn`` is
    applied to the module's output within the same node (a Keras layer with
    a fused activation stays ONE layer for index parity). ``features`` is
    the output channel count of a parameterized layer.
    """

    name: str
    kind: str
    inputs: Tuple[str, ...]
    module_fn: Optional[Callable[[torch.Generator], nn.Module]] = None
    fn: Optional[Callable[..., Any]] = None
    post_fn: Optional[Callable[..., Any]] = None
    features: Optional[int] = None

    @property
    def has_params(self) -> bool:
        return self.module_fn is not None and self.kind != KIND_DROPOUT


class GraphError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class LayerGraph:
    """A topologically-ordered DAG of layers. Index 0 is the input node."""

    layers: Tuple[LayerSpec, ...]
    output: str = ""  # defaults to last layer

    def __post_init__(self):
        if not self.layers or self.layers[0].name != INPUT:
            raise GraphError("graph must start with the input node")
        seen = set()
        for spec in self.layers:
            for inp in spec.inputs:
                if inp not in seen:
                    raise GraphError(
                        f"layer {spec.name!r} consumes {inp!r} before it is "
                        f"produced")
            if spec.name in seen:
                raise GraphError(f"duplicate layer name {spec.name!r}")
            seen.add(spec.name)
        out = self.output or self.layers[-1].name
        if out not in seen:
            raise GraphError(f"output node {out!r} not in graph")
        object.__setattr__(self, "output", out)

    # Lookup ---------------------------------------------------------------
    def index_of(self, name: str) -> int:
        for i, spec in enumerate(self.layers):
            if spec.name == name:
                return i
        raise GraphError(f"no layer named {name!r}")

    def __getitem__(self, key) -> LayerSpec:
        if isinstance(key, str):
            return self.layers[self.index_of(key)]
        return self.layers[key]

    @property
    def layer_names(self) -> List[str]:
        return [s.name for s in self.layers]

    def features_of(self, name: str) -> int:
        """Channel count of layer ``name``'s output: its own ``features``,
        else (activations, pools, dropout) its first input's."""
        spec = self[name]
        while spec.features is None:
            if not spec.inputs:
                raise GraphError(f"no channel count known for {name!r}")
            spec = self[spec.inputs[0]]
        return spec.features

    def last_layer_of_kind(self, *kinds: str) -> str:
        """Name of the last layer whose kind is one of ``kinds`` (the
        Grad-CAM conv tap scans for the last 'Conv' layer)."""
        for spec in reversed(self.layers):
            if spec.kind in kinds:
                return spec.name
        raise GraphError(f"graph has no layer of kind {kinds!r}")

    # Transformations ------------------------------------------------------
    def cut(self, at) -> "LayerGraph":
        """Truncate the graph so that layer ``at`` (index or name, Keras
        numbering with the input node at 0) becomes the output — the analogue
        of ``Model(base.input, base.layers[idx].output)``."""
        idx = self.index_of(at) if isinstance(at, str) else (
            at if at >= 0 else len(self.layers) + at
        )
        if idx <= 0:
            raise GraphError("cannot cut at the input node")
        if idx >= len(self.layers):
            raise GraphError(
                f"cut index {at} out of range for a {len(self.layers)}-layer "
                f"graph")
        keep = self.layers[: idx + 1]
        names = {s.name for s in keep}
        for spec in keep[1:]:
            for inp in spec.inputs:
                if inp not in names:
                    raise GraphError(
                        f"cut at {at!r} severs input {inp!r} of {spec.name!r}"
                    )
        return LayerGraph(layers=keep, output=keep[-1].name)

    def append(self, specs: Sequence[LayerSpec],
               output: Optional[str] = None) -> "LayerGraph":
        """New graph with ``specs`` appended (a classification head, say)."""
        return LayerGraph(layers=self.layers + tuple(specs),
                          output=output or specs[-1].name)

    def trainable_mask(self, freeze_idx: int,
                       freeze_bn_always: bool = True,
                       backbone_len: Optional[int] = None) -> Dict[str, bool]:
        """Keras ``freeze_layers`` semantics: layers with index <=
        freeze_idx are frozen, BatchNorm layers at any index;
        ``freeze_idx < 0`` freezes nothing by index. ``backbone_len`` scopes
        freezing to the first N layers, so head layers are never frozen."""
        mask: Dict[str, bool] = {}
        limit = len(self.layers) if backbone_len is None else backbone_len
        for i, spec in enumerate(self.layers):
            if not spec.has_params:
                continue
            trainable = True
            if i < limit:
                if freeze_idx >= 0 and i <= freeze_idx:
                    trainable = False
                if freeze_bn_always and spec.kind == KIND_BN:
                    trainable = False
            mask[spec.name] = trainable
        return mask

    def param_layer_names(self) -> List[str]:
        return [s.name for s in self.layers if s.has_params]


def _to_internal(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2) if x.ndim == 4 else x


def _to_public(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1) if x.ndim == 4 else x


class GraphModule(nn.Module):
    """``nn.Module`` executing a :class:`LayerGraph` on NHWC input.

    ``capture`` names intermediate activations returned (NHWC) beside the
    output from the same forward pass. Dropout follows ``self.training``.
    """

    def __init__(self, graph: LayerGraph, capture: Tuple[str, ...] = (),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.graph = graph
        self.capture = tuple(capture)
        for spec in graph.layers[1:]:
            if spec.module_fn is not None:
                self.add_module(spec.name, spec.module_fn(generator))

    def forward(self, x: torch.Tensor,
                overrides: Optional[Dict[str, torch.Tensor]] = None):
        """``overrides`` injects activations (NHWC) by layer name: the node's
        computation is skipped and the given tensor used instead."""
        acts: Dict[str, torch.Tensor] = {INPUT: _to_internal(x)}
        overrides = overrides or {}
        for spec in self.graph.layers[1:]:
            if spec.name in overrides:
                acts[spec.name] = _to_internal(overrides[spec.name])
                continue
            ins = [acts[n] for n in spec.inputs]
            if spec.module_fn is not None:
                y = self._modules[spec.name](*ins)
                if spec.post_fn is not None:
                    y = spec.post_fn(y)
            else:
                y = spec.fn(*ins)
            acts[spec.name] = y
        out = _to_public(acts[self.graph.output])
        if self.capture:
            return out, {n: _to_public(acts[n]) for n in self.capture}
        return out


# ---------------------------------------------------------------------------
# Keras-convention layer factories
# ---------------------------------------------------------------------------

def glorot_uniform_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Keras's default kernel initializer, for ``[out, in, *kernel]``
    weights: U(-l, l) with ``l = sqrt(6 / (fan_in + fan_out))``."""
    receptive = math.prod(weight.shape[2:])
    fan_in, fan_out = weight.shape[1] * receptive, weight.shape[0] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.uniform_(-limit, limit, generator=generator)


def _keras_init(module: nn.Module, generator: torch.Generator,
                bias_init: Optional[Callable[[torch.Tensor], None]] = None
                ) -> nn.Module:
    glorot_uniform_(module.weight, generator)
    if module.bias is not None:
        with torch.no_grad():
            module.bias.zero_()
            if bias_init is not None:
                bias_init(module.bias)
    return module


def conv2d(name: str, inp: str, in_features: int, features: int,
           kernel: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
           padding: str = "SAME", use_bias: bool = True,
           act: Optional[Callable] = None) -> LayerSpec:
    """Keras Conv2D. Stride-1 ``SAME`` with an odd kernel is symmetric
    padding; TF's asymmetric stride-2 ``SAME`` is not needed yet."""
    if padding == "VALID":
        pad = (0, 0)
    elif padding == "SAME" and tuple(strides) == (1, 1) and all(
            k % 2 for k in kernel):
        pad = (kernel[0] // 2, kernel[1] // 2)
    else:
        raise NotImplementedError(
            f"conv {name!r}: {padding} padding at strides {strides} with "
            f"kernel {kernel} {_NOT_YET}")

    def factory(generator):
        return _keras_init(nn.Conv2d(in_features, features, tuple(kernel),
                                     stride=tuple(strides), padding=pad,
                                     bias=use_bias), generator)
    return LayerSpec(name=name, kind=KIND_CONV, inputs=(inp,),
                     module_fn=factory, post_fn=act, features=features)


def dense(name: str, inp: str, in_features: int, features: int,
          use_bias: bool = True,
          bias_init: Optional[Callable[[torch.Tensor], None]] = None,
          act: Optional[Callable] = None) -> LayerSpec:
    def factory(generator):
        return _keras_init(nn.Linear(in_features, features, bias=use_bias),
                           generator, bias_init)
    return LayerSpec(name=name, kind=KIND_DENSE, inputs=(inp,),
                     module_fn=factory, post_fn=act, features=features)


def dropout(name: str, inp: str, rate: float) -> LayerSpec:
    return LayerSpec(name=name, kind=KIND_DROPOUT, inputs=(inp,),
                     module_fn=lambda generator: nn.Dropout(rate))


def activation(name: str, inp: str, fn: Callable) -> LayerSpec:
    return LayerSpec(name=name, kind=KIND_FN, inputs=(inp,), fn=fn)


def relu(name: str, inp: str) -> LayerSpec:
    return activation(name, inp, F.relu)


def _softmax_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x.to(torch.float32), dim=-1)


def softmax(name: str, inp: str) -> LayerSpec:
    """float32 softmax whatever the compute dtype (the reference pins its
    output activation to float32)."""
    return activation(name, inp, _softmax_f32)


def max_pool(name: str, inp: str, window: Tuple[int, int],
             strides: Optional[Tuple[int, int]] = None,
             padding: str = "VALID") -> LayerSpec:
    if padding != "VALID":
        raise NotImplementedError(f"max_pool {name!r}: {padding} padding "
                                  f"{_NOT_YET}")
    window, strides = tuple(window), tuple(strides or window)
    return LayerSpec(
        name=name, kind=KIND_FN, inputs=(inp,),
        fn=lambda x: F.max_pool2d(x, window, strides))


def global_avg_pool(name: str, inp: str) -> LayerSpec:
    return LayerSpec(name=name, kind=KIND_FN, inputs=(inp,),
                     fn=lambda x: x.mean(dim=(2, 3)))


def input_node() -> LayerSpec:
    return LayerSpec(name=INPUT, kind=KIND_FN, inputs=(), fn=lambda: None)


def graph_of(*specs: LayerSpec, output: Optional[str] = None) -> LayerGraph:
    return LayerGraph(layers=(input_node(),) + tuple(specs),
                      output=output or specs[-1].name)
