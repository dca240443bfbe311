"""Layer-graph IR (port of the JAX package's ``graph.py``).

Models are an explicit DAG of named :class:`LayerSpec` nodes in Keras
topological order (node 0 is the input, matching ``keras.Model.layers``
numbering), so the reference's index-based operations keep their meaning:

* :meth:`LayerGraph.cut` — truncate at a layer index/name (CUTOFF_IDX).
* :meth:`LayerGraph.segment` — the layers between two names as a graph of
  their own (attribution's stages).
* :meth:`LayerGraph.trainable_mask` — per-layer trainability (FREEZE_IDX).
* :meth:`LayerGraph.last_layer_of_kind` — e.g. the Grad-CAM conv tap.
* :class:`GraphModule` — an ``nn.Module`` executing the DAG, with
  ``capture`` (return named intermediate activations from the same pass),
  ``overrides`` (inject an activation by layer name) and ``leaf`` (make
  one activation the start of autograd's record: Grad-CAM's tap), which
  Grad-CAM and attribution build on.

Parameterized layers are submodules named by their Keras layer name, so the
state-dict keys read ``block1_conv1.weight`` (a separable conv's nested
layers read ``block2_sepconv1.depthwise.weight``). Layouts: the module's
public tensors are NHWC, as in the JAX package; inside, 4-D activations are
NCHW views of NHWC memory (``channels_last``), the layout cuDNN and the
depthwise kernel want.

Precision. A mixed-precision model serves cast to bfloat16 as a whole
(``module.to(dtype=torch.bfloat16)``), which casts every conv and dense
weight, as flax's ``dtype=bfloat16`` layers do. It trains in the other form
flax has (:func:`set_compute_dtype`): float32 parameters, each conv, dense
and depthwise layer casting its weight, bias and input to bfloat16 inside
its forward (flax's ``promote_dtype``), so that an optimizer step updates
the float32 master copy. :class:`BatchNorm` and :class:`Normalization` keep
their parameters and statistics in float32 through a cast (their
``_apply`` restores the float32 tensors, moved to the new device), because
flax keeps them in float32: its ``BatchNorm`` normalizes a bfloat16 input
in float32 against float32 statistics and casts to bfloat16 at the end,
which is what ``F.batch_norm`` does with a bfloat16 input and float32
statistics. ``Normalization`` computes in the input's dtype, as the JAX
layer does.

Training. Dropout draws from the ``torch.Generator`` handed to
``GraphModule.forward`` (the trainer's per-step generator). A batch norm
in training mode normalizes with the batch's statistics and moves its
running ones by flax's rule (biased variance); one listed in
``inference_bn`` (a layer frozen in the phase) runs in inference mode in
training too and never moves them.

Stacked trials. The trial-parallel trainer (``parallel/trial_parallel.py``)
runs the module under ``torch.func.vmap`` over ``functional_call``, with
every parameter and buffer stacked along a leading trial axis. There a
forward takes ``bn_stats`` (a dict): each batch norm normalizes in float32,
written out (:meth:`BatchNorm.stacked`), and, in training, puts its new
running statistics into it under its name instead of replacing its
buffers, which ``functional_call`` would drop;
and ``dropout_masks``: each dropout layer applies the keep mask given under
its name (drawn outside the vmapped forward, one generator per trial,
:func:`dropout_mask_shapes`) instead of drawing one.

Data parallelism. Under a device mesh each rank runs its rows of the
global batch, and :func:`set_data_parallel` makes the module's layers
behave as the JAX package's, whose one program sees the global batch: a
training batch norm takes the global batch's statistics (the per-channel
sums all-reduced over the ``data`` group, differentiably, and under
``torch.func.vmap`` for every trial at once), and a dropout layer draws
the global batch's mask from the step's generator and keeps its rows.

TF ``SAME`` padding: at stride 1 with an odd kernel it is symmetric; at
stride 2 it depends on the input size and puts the odd pixel bottom/right
(``ops/padding.py``), so those convs and max-pools pad explicitly (max-pool
with ``-inf``); ``padding='same'`` in PyTorch refuses stride > 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ab_line_classifier_torch.ops import bn_act_cuda as BA
from ab_line_classifier_torch.ops import conv_epilogue_cuda as CE
from ab_line_classifier_torch.ops import depthwise as DW
from ab_line_classifier_torch.ops._build import DTYPES, VECTOR_CHANNELS
from ab_line_classifier_torch.ops.depthwise_cuda import pack_weight
from ab_line_classifier_torch.ops.padding import pad_hw, pad_same

INPUT = "__input__"

# Layer kinds with special call conventions or freeze semantics.
KIND_CONV = "conv"
KIND_DEPTHWISE = "depthwise"
KIND_BN = "bn"
KIND_DENSE = "dense"
KIND_DROPOUT = "dropout"
KIND_FN = "fn"  # pure function of its inputs (activation, pool, add, pad...)
KIND_NORM = "norm"

# Public NHWC axis -> internal NCHW axis of a 4-D activation.
_INTERNAL_AXIS = {0: 0, 1: 2, 2: 3, 3: 1}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One node of the model DAG.

    Exactly one of ``module_fn`` / ``fn`` is set. ``module_fn`` takes a
    ``torch.Generator`` and returns the layer's initialized ``nn.Module``;
    ``fn`` is a pure function of the input activations. ``post_fn`` is
    applied to the module's output within the same node (a Keras layer with
    a fused activation stays ONE layer for index parity). ``features`` is
    the output channel count of a parameterized layer. ``op`` states what a
    ``fn`` layer computes as data, ``(kind, *arguments)`` (``("max_pool",
    window, strides, padding)``, ``("div", 255.0)``...), for the ONNX
    exporter, which cannot read a closure; an activation leaves it empty and
    is known by its ``fn``.
    """

    name: str
    kind: str
    inputs: Tuple[str, ...]
    module_fn: Optional[Callable[[torch.Generator], nn.Module]] = None
    fn: Optional[Callable[..., Any]] = None
    post_fn: Optional[Callable[..., Any]] = None
    features: Optional[int] = None
    op: Tuple[Any, ...] = ()

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

    def segment(self, prev: Optional[str], at: str) -> "LayerGraph":
        """The layers after ``prev`` up to ``at`` (by name), as a graph of
        their own whose input node stands for ``prev``'s activation
        (``prev`` None: the model input, which is :meth:`cut`). A module of
        it runs those layers and nothing before them, under the full
        model's layer names, so the full state dict's entries for them load
        into it. Raises if a kept layer reads a layer before ``prev``, or
        ``prev`` does not come before ``at``."""
        if prev is None:
            return self if at == self.output else self.cut(at)
        lo, hi = self.index_of(prev), self.index_of(at)
        if not lo < hi:
            raise GraphError(f"segment ({prev!r}, {at!r}] is empty")
        keep = self.layers[lo + 1: hi + 1]
        names = {s.name for s in keep}
        specs = []
        for spec in keep:
            for inp in spec.inputs:
                if inp != prev and inp not in names:
                    raise GraphError(
                        f"segment ({prev!r}, {at!r}] severs input {inp!r} "
                        f"of {spec.name!r}")
            specs.append(dataclasses.replace(spec, inputs=tuple(
                INPUT if inp == prev else inp for inp in spec.inputs)))
        return LayerGraph(layers=(input_node(),) + tuple(specs), output=at)

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
    output from the same forward pass. Dropout and batch norm follow
    ``self.training``; the batch norms named in ``inference_bn`` run in
    inference mode in training too (:meth:`set_inference_bn`).

    Fused kernels. A layer runs through a hand-written kernel where the
    route table (:class:`_Route`, fixed from the graph here) names it: a
    :class:`Conv2d` with a bias and a ReLU or no activation, through the
    conv epilogue (``ops/conv_epilogue_cuda.py``: the conv runs without its
    bias, and one pass adds it and takes the ReLU); a :class:`BatchNorm`
    with no activation of its own, through the batch norm pass
    (``ops/bn_act_cuda.py``). Either over whole 16-byte vectors of channels
    (``C % 8 == 0``). Where the layer's only reader is what its kernel can
    take too (the conv's 2x2 stride-2 ``VALID`` max-pool; the batch norm's
    ReLU, ReLU6 or swish, ``op=("relu6",)``, ``F.relu``, ``F.silu``) and the
    layer is neither captured nor the output, the same pass folds the
    reader in, and the reader's node takes that result. The layer stays a
    call of its module, so its hooks run: the conv without its bias (a
    forward hook sees the conv's output), the batch norm with ``act=``
    (``adapt_batch_norm``'s hooks; a forward hook sees the activation's
    output where it is folded in). Each call keeps the library chain (the
    layer as its module computes it, then its reader) where autograd would
    record the layer (grad mode on and its input or a parameter requiring
    grad, or a ``torch.func`` transform's tensors), where its input is not
    NHWC memory or it computes in a dtype the kernels do not take, and for
    a batch norm that normalizes with its batch's statistics or under
    ``bn_stats``; and keeps the reader apart where ``overrides`` names it,
    or ``leaf`` names the layer or, for the conv, its pool. The results are
    bit-equal to the chain's on the card: the library's conv adds its bias
    after the conv too, and the batch norm pass rounds as ATen's batch norm
    and activation do; on the CPU each kernel is its plain version, the
    chain.
    """

    def __init__(self, graph: LayerGraph, capture: Tuple[str, ...] = (),
                 generator: Optional[torch.Generator] = None,
                 inference_bn: Tuple[str, ...] = ()):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.graph = graph
        self.capture = tuple(capture)
        # After each layer, the activations no later layer reads: the
        # forward lets them go there (the output and the captures stay),
        # so a pass holds what is live, not every activation of the graph.
        last = {}
        for i, spec in enumerate(graph.layers[1:]):
            last.update((n, i) for n in spec.inputs)
        keep = {graph.output, *self.capture}
        self._dead_after = [[] for _ in graph.layers[1:]]
        for n, i in last.items():
            if n not in keep:
                self._dead_after[i].append(n)
        for spec in graph.layers[1:]:
            if spec.module_fn is not None:
                self.add_module(spec.name, spec.module_fn(generator))
        readers: Dict[str, List[LayerSpec]] = {}
        for spec in graph.layers[1:]:
            for n in spec.inputs:
                readers.setdefault(n, []).append(spec)
        # layer name -> its route through a fused kernel.
        self._routes: Dict[str, _Route] = {}
        for spec in graph.layers[1:]:
            m = self._modules.get(spec.name)
            if spec.features is None or spec.features % VECTOR_CHANNELS:
                continue
            after = readers.get(spec.name, [])
            reader = (after[0] if len(after) == 1 and spec.name not in keep
                      else None)
            if (spec.kind == KIND_CONV and isinstance(m, Conv2d)
                    and m.bias is not None
                    and _activation(spec.post_fn) in CE.ACTS):
                relu = spec.post_fn is F.relu
                pool = (reader.name if reader is not None
                        and reader.op == CE.POOL else None)
                self._routes[spec.name] = _Route(
                    _conv_epilogue, (relu, pool is not None),
                    (relu, False), pool, (spec.name, pool))
            elif (spec.kind == KIND_BN and isinstance(m, BatchNorm)
                    and spec.post_fn is None):
                act = (_activation(reader.fn, reader.op)
                       if reader is not None and reader.kind == KIND_FN
                       else None)
                if act == "none" or act not in BA.ACTS:
                    act = reader = None
                self._routes[spec.name] = _Route(
                    _bn_act, (act or "none",), ("none",),
                    reader and reader.name, (spec.name,))
        self.set_inference_bn(inference_bn)

    def set_inference_bn(self, names: Sequence[str]) -> None:
        """Run exactly the batch norms in ``names`` in inference mode during
        training (Keras ``trainable=False`` BN: the running statistics
        normalize and never move)."""
        names = set(names)
        for spec in self.graph.layers[1:]:
            if spec.kind == KIND_BN:
                self._modules[spec.name].frozen = spec.name in names

    def forward(self, x: torch.Tensor,
                overrides: Optional[Dict[str, torch.Tensor]] = None,
                leaf: Optional[str] = None,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[Dict[str, torch.Tensor]] = None,
                bn_stats: Optional[Dict[str, Tuple[torch.Tensor,
                                                   torch.Tensor]]] = None):
        """``overrides`` injects activations (NHWC) by layer name: the node's
        computation is skipped and the given tensor used instead.

        ``leaf`` names a node whose output (NHWC) is detached into a new
        autograd leaf that requires grad, returned as a capture: autograd
        records what follows it and nothing before it, in the same single
        pass (Grad-CAM's tap).

        ``generator`` is what dropout draws from in training mode (on the
        activations' device); ``dropout_masks`` gives each dropout layer its
        keep mask instead. ``bn_stats``, a dict, makes every batch norm
        take the stacked form (:meth:`BatchNorm.stacked`) and collects the
        new running statistics of those that train."""
        acts: Dict[str, torch.Tensor] = {INPUT: _to_internal(x)}
        overrides = overrides or {}
        captured = {}
        # Pools and activations the node before them computed in this call.
        folded = set()
        for i, spec in enumerate(self.graph.layers[1:]):
            if spec.name in overrides:
                acts[spec.name] = _to_internal(overrides[spec.name])
                for n in self._dead_after[i]:
                    del acts[n]
                continue
            ins = [acts[n] for n in spec.inputs]
            if spec.name in folded:
                y = ins[0]
            elif spec.kind == KIND_BN and bn_stats is not None:
                y, stats = self._modules[spec.name].stacked(ins[0])
                if stats is not None:
                    bn_stats[spec.name] = stats
            elif (route := self._route(spec.name, ins[0], overrides,
                                       leaf)) is not None:
                run, args, reader = route
                y = run(self._modules[spec.name], ins[0], *args)
                if reader is not None:
                    folded.add(reader)
            elif spec.kind == KIND_DROPOUT:
                y = self._modules[spec.name](
                    ins[0], generator,
                    mask=(dropout_masks or {}).get(spec.name))
            elif spec.module_fn is not None:
                y = self._modules[spec.name](*ins)
                if spec.post_fn is not None:
                    y = spec.post_fn(y)
            else:
                y = spec.fn(*ins)
            if spec.name == leaf:
                captured[leaf] = _to_public(y).detach().requires_grad_()
                y = _to_internal(captured[leaf])
            acts[spec.name] = y
            for n in self._dead_after[i]:
                del acts[n]
        out = _to_public(acts[self.graph.output])
        if leaf is not None and leaf not in captured:
            raise GraphError(f"no computed layer named {leaf!r}")
        captured.update((n, _to_public(acts[n])) for n in self.capture
                        if n not in captured)
        return (out, captured) if captured else out

    def _route(self, name: str, x: torch.Tensor,
               overrides: Dict[str, torch.Tensor], leaf: Optional[str]
               ) -> Optional[Tuple[Callable[..., torch.Tensor], tuple,
                                   Optional[str]]]:
        """``(run, its arguments, the reader it folds in or None)`` of
        layer ``name`` on input ``x`` in this call, or ``None`` where it
        keeps the library chain (class docstring)."""
        route = self._routes.get(name)
        if route is None:
            return None
        m = self._modules[name]
        if (_recorded(x, *m._parameters.values(),
                      stats=tuple(m._buffers.values()))
                or (getattr(m, "compute_dtype", None) or x.dtype)
                not in DTYPES
                or not x.is_contiguous(memory_format=torch.channels_last)
                or isinstance(m, BatchNorm) and m.training and not m.frozen):
            return None
        if route.reader is not None and (route.reader in overrides
                                         or leaf in route.unfold):
            return route.run, route.alone, None
        return route.run, route.args, route.reader


@dataclasses.dataclass(frozen=True)
class _Route:
    """A layer that runs through a fused kernel (``GraphModule``'s
    docstring): ``run(module, x, *args)`` with ``reader`` folded in,
    ``run(module, x, *alone)`` with it apart (``reader`` None: ``args`` is
    ``alone``), which ``leaf`` at one of ``unfold`` asks for."""

    run: Callable[..., torch.Tensor]
    args: tuple
    alone: tuple
    reader: Optional[str]
    unfold: Tuple[Optional[str], ...]


def _conv_epilogue(m: Conv2d, x: torch.Tensor, relu: bool,
                   pool: bool) -> torch.Tensor:
    """The conv as its module without its bias, then its bias, ``relu``
    and with ``pool`` its reader's pool in one pass."""
    return CE.conv_epilogue(m(x, bias=False),
                            _cast(m.compute_dtype, m.bias)[0], relu, pool)


def _bn_act(m: BatchNorm, x: torch.Tensor, act: str) -> torch.Tensor:
    """The batch norm as its module, ``act`` taken in the same pass."""
    return m(x, act=act)


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


def _recorded(*ts: Optional[torch.Tensor],
              stats: Tuple[torch.Tensor, ...] = ()) -> bool:
    """Whether autograd or a ``torch.func`` transform would record a layer
    of inputs and parameters ``ts`` (``None``: absent) and statistics
    ``stats``: then it keeps the library chain, which they see through."""
    return (any(t is not None
                and torch._C._functorch.is_functorch_wrapped_tensor(t)
                for t in (*ts, *stats))
            or torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in ts))


def _activation(fn: Optional[Callable], op: Tuple[Any, ...] = ()
                ) -> Optional[str]:
    """The fused kernels' name (``ops/bn_act_cuda.ACTS``) of the
    activation ``fn`` (``op``: stated as data), ``"none"`` for none, or
    ``None`` where it is none they know."""
    if op == ("relu6",):
        return "relu6"
    if op:
        return None
    return {None: "none", F.relu: "relu", F.silu: "swish"}.get(fn)


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


def _cast(dtype: Optional[torch.dtype], *ts: Optional[torch.Tensor]):
    """``ts`` cast to ``dtype`` (``None`` stays ``None``); unchanged when
    ``dtype`` is ``None``: flax's ``promote_dtype`` of a layer's input and
    parameters."""
    if dtype is None:
        return ts
    return tuple(None if t is None else t.to(dtype) for t in ts)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` when it is set
    (:func:`set_compute_dtype`). ``bias=False`` leaves the bias out of the
    call: :class:`GraphModule` then adds it in the conv epilogue."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        x, w, b = _cast(self.compute_dtype, x, self.weight,
                        self.bias if bias else None)
        return self._conv_forward(x, w, b)


def with_init(spec: LayerSpec,
              init: Callable[[nn.Module, torch.Generator], None]
              ) -> LayerSpec:
    """``spec`` with ``init(module, generator)`` applied after its factory:
    a kernel initializer other than Keras's default glorot-uniform."""
    base = spec.module_fn

    def factory(generator):
        m = base(generator)
        init(m, generator)
        return m
    return dataclasses.replace(spec, module_fn=factory)


class SameConv2d(Conv2d):
    """:class:`Conv2d` with TF ``SAME`` padding computed from the input size
    (the stride-2 case, where it can be asymmetric)."""

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        return super().forward(pad_same(x, self.kernel_size, self.stride),
                               bias)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype`` when it is set."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _cast(self.compute_dtype, x, self.weight, self.bias)
        return F.linear(x, w, b)


def conv2d(name: str, inp: str, in_features: int, features: int,
           kernel: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
           padding: str = "SAME", use_bias: bool = True,
           act: Optional[Callable] = None) -> LayerSpec:
    """Keras Conv2D. ``VALID``, or TF ``SAME``: symmetric padding inside
    the conv at stride 1 with an odd kernel, explicit padding otherwise."""
    kernel, strides = tuple(kernel), tuple(strides)
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"conv {name!r}: unknown padding {padding!r}")
    symmetric = strides == (1, 1) and all(k % 2 for k in kernel)
    cls = SameConv2d if padding == "SAME" and not symmetric else Conv2d
    pad = ((kernel[0] // 2, kernel[1] // 2) if padding == "SAME" and symmetric
           else (0, 0))

    def factory(generator):
        return _keras_init(cls(in_features, features, kernel, stride=strides,
                               padding=pad, bias=use_bias), generator)
    return LayerSpec(name=name, kind=KIND_CONV, inputs=(inp,),
                     module_fn=factory, post_fn=act, features=features)


class DepthwiseConv(nn.Module):
    """Keras DepthwiseConv2D (depth multiplier 1) on the depthwise kernel
    (``ops/depthwise.py::depthwise_conv``): on CUDA every stride-1 ``SAME``
    layer with an odd kernel up to 7 launches the hand-written kernel, any
    other configuration runs the grouped conv. ``weight`` is
    ``[C, 1, K, K]``, PyTorch's grouped-conv layout. The kernel reads the
    weight as the forward casts it (to ``compute_dtype`` when that is set),
    repacked to float32 ``[K, K, C]``; the repacked copy is cached here and
    rebuilt only when the weight changes (another tensor, device or dtype,
    an in-place update such as an optimizer step, or another compute
    dtype)."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, channels: int, kernel: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), padding: str = "SAME",
                 use_bias: bool = False):
        super().__init__()
        if kernel[0] != kernel[1] or strides[0] != strides[1]:
            raise ValueError("DepthwiseConv takes square kernels and strides")
        self.stride = int(strides[0])
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(channels, 1, *kernel))
        self.bias = (nn.Parameter(torch.zeros(channels)) if use_bias
                     else None)
        self._packed: Tuple[Any, Optional[torch.Tensor]] = (None, None)

    def packed_weight(self) -> torch.Tensor:
        w, cd = self.weight, self.compute_dtype
        key = (w.data_ptr(), w._version, w.dtype, w.device, cd)
        if self._packed[0] != key:
            self._packed = (key, pack_weight(w if cd is None else w.to(cd)))
        return self._packed[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _cast(self.compute_dtype, x, self.weight, self.bias)
        # Stacked trials (a vmapped weight) pack inside the kernel's trial
        # launch, every forward: the weights change every step.
        cached = (x.is_cuda
                  and not torch._C._functorch.is_batchedtensor(self.weight))
        y = DW.depthwise_conv(x, w, self.stride, self.padding,
                              packed=self.packed_weight() if cached
                              else None)
        if b is not None:
            y = y + b.view(1, -1, 1, 1)
        return y


def drop_packed_weights(module: nn.Module) -> None:
    """Forget every :class:`DepthwiseConv`'s packed weight, so the next
    forward packs anew. A CUDA graph's capture must record the packing
    (its replays update the weight without the host seeing a new version),
    and a pack made at a capture lives in the graph's memory, which later
    replays overwrite."""
    for m in module.modules():
        if isinstance(m, DepthwiseConv):
            m._packed = (None, None)


def depthwise_conv2d(name: str, inp: str, channels: int,
                     kernel: Tuple[int, int],
                     strides: Tuple[int, int] = (1, 1), padding: str = "SAME",
                     use_bias: bool = False) -> LayerSpec:
    def factory(generator):
        return _keras_init(DepthwiseConv(channels, tuple(kernel),
                                         tuple(strides), padding, use_bias),
                           generator)
    return LayerSpec(name=name, kind=KIND_DEPTHWISE, inputs=(inp,),
                     module_fn=factory, features=channels)


class SeparableConv(nn.Module):
    """Keras SeparableConv2D as one layer: a depthwise conv (no bias), then
    a 1x1 pointwise conv; nested as ``depthwise`` / ``pointwise``."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
                 padding: str = "SAME", use_bias: bool = True):
        super().__init__()
        self.depthwise = DepthwiseConv(in_features, kernel, strides, padding)
        self.pointwise = Conv2d(in_features, features, 1, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


def separable_conv2d(name: str, inp: str, in_features: int, features: int,
                     kernel: Tuple[int, int],
                     strides: Tuple[int, int] = (1, 1),
                     padding: str = "SAME", use_bias: bool = True
                     ) -> LayerSpec:
    def factory(generator):
        m = SeparableConv(in_features, features, tuple(kernel),
                          tuple(strides), padding, use_bias)
        _keras_init(m.depthwise, generator)
        _keras_init(m.pointwise, generator)
        return m
    # kind=conv: Grad-CAM's last-conv scan matches SeparableConv2D layers.
    return LayerSpec(name=name, kind=KIND_CONV, inputs=(inp,),
                     module_fn=factory, features=features)


class _Float32State(nn.Module):
    """Keeps every parameter and buffer in float32 through dtype casts
    (``module.to(dtype=...)``, ``.bfloat16()``): the float32 values are
    restored, on the device the cast moved to."""

    def _apply(self, fn, recurse=True):
        kept = {n: t.detach() for n, t in list(self._parameters.items())
                + list(self._buffers.items()) if t is not None}
        super()._apply(fn, recurse)
        for n, old in kept.items():
            new = getattr(self, n)
            if new.dtype == torch.float32:
                continue
            fixed = old.to(device=new.device)
            if n in self._parameters:
                self._parameters[n] = nn.Parameter(
                    fixed, requires_grad=new.requires_grad)
            else:
                self._buffers[n] = fixed
        return self


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group, differentiable: the backward sums the
    gradients over the same group (each rank's loss depends on every
    rank's input through the sum). Under ``torch.func.vmap`` the batched
    tensor is reduced whole, so every trial's statistics go in one
    ``all_reduce`` (a collective has no batching rule of its own)."""

    @staticmethod
    def forward(x, group):
        out = x.detach().contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _AllReduceSum.apply(x, group), in_dims[0]


class BatchNorm(_Float32State):
    """Keras BatchNormalization (flax ``BatchNorm``): ``weight``/``bias``
    (flax ``scale``/``bias``) and the ``running_mean``/``running_var``
    buffers (flax ``batch_stats`` ``mean``/``var``), all float32. Serving,
    and training while ``frozen``, normalize with the running statistics.
    Otherwise training normalizes with the batch's statistics and moves the
    running ones by flax's rule: the batch mean and the biased batch
    variance, both in float32, and ``ra = momentum * ra + (1 - momentum) *
    batch``. ``F.batch_norm`` moves the running statistics by that rule
    from the statistics of its own pass, but with the unbiased variance
    ``n / (n - 1) * var``; one ``lerp`` takes the excess back.

    With a ``group`` (:func:`set_data_parallel`), training statistics are
    the global batch's: the per-channel sum, then the sum of squared
    deviations from the global mean, each all-reduced over the group
    (:class:`_AllReduceSum`), normalized in float32 as
    :meth:`stacked` writes it out; every rank moves its running statistics
    by flax's rule from the same global ones."""

    frozen = False
    group = None

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-3, scale: bool = True):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.ones(features)) if scale else None
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                act: Optional[str] = None) -> torch.Tensor:
        """``act``, one of ``ops/bn_act_cuda.ACTS``, runs the layer with
        its running statistics through the batch norm pass, the activation
        applied (:class:`GraphModule` decides where)."""
        if act is not None:
            return BA.bn_act(x, self.running_mean, self.running_var,
                             self.weight, self.bias, self.epsilon, act)
        if not self.training or self.frozen:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.epsilon)
        m, n = self.momentum, x.numel() // x.shape[1]
        if self.group is not None:
            y, mean, var = self._train_norm(x)
            with torch.no_grad():
                self.running_mean = (self.running_mean * m
                                     + mean.detach() * (1.0 - m))
                self.running_var = (self.running_var * m
                                    + var.detach() * (1.0 - m))
            return y
        with torch.no_grad():
            kept = self.running_var * m
        y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                         self.bias, True, 1.0 - m, self.epsilon)
        with torch.no_grad():
            # (1 - 1/n) (m ra + (1 - m) n/(n-1) var) + m ra / n
            #   = m ra + (1 - m) var. A new tensor: autograd holds the one
            # batch_norm was given.
            self.running_var = torch.lerp(self.running_var, kept, 1.0 / n)
        return y

    def stacked(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor,
                                                        torch.Tensor]]]:
        """The layer under ``torch.func.vmap`` with stacked statistics:
        ``(y, (mean, var))``, the new running statistics by flax's rule
        (the batch mean and biased variance, ``ra = m * ra + (1 - m) *
        batch``; ``None`` where they do not move), left to the caller
        instead of replacing the buffers. Written out in float32 and
        returned in ``x``'s dtype, as ``F.batch_norm`` computes a bfloat16
        input against float32 statistics: vmap's batch-norm rule takes one
        dtype, and on CUDA asks for a memory format that a vmapped tensor
        cannot report."""
        if not (self.training and not self.frozen):
            return self._normalize(x, self.running_mean,
                                   self.running_var), None
        y, mean, var = self._train_norm(x)
        m = self.momentum
        with torch.no_grad():
            stats = (self.running_mean * m + mean.detach() * (1.0 - m),
                     self.running_var * m + var.detach() * (1.0 - m))
        return y, stats

    def _normalize(self, x: torch.Tensor, mean: torch.Tensor,
                   var: torch.Tensor) -> torch.Tensor:
        """``x`` normalized by ``mean`` and ``var`` in float32, scaled and
        shifted, in ``x``'s dtype."""
        shape = (1, -1) + (1,) * (x.ndim - 2)
        scale = torch.rsqrt(var + self.epsilon)
        if self.weight is not None:
            scale = scale * self.weight
        y = ((x.to(torch.float32) - mean.view(shape)) * scale.view(shape)
             + self.bias.view(shape))
        return y.to(x.dtype)

    def _train_norm(self, x: torch.Tensor):
        """``(y, mean, var)``: ``x`` normalized by its batch's mean and
        biased variance (float32; the global batch's over ``group``)."""
        xf = x.to(torch.float32)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        dims = (0,) + tuple(range(2, x.ndim))
        if self.group is None:
            mean = xf.mean(dims)
            var = (xf - mean.view(shape)).square().mean(dims)
        else:
            n = xf.numel() // xf.shape[1] * dist.get_world_size(self.group)
            mean = _AllReduceSum.apply(xf.sum(dims), self.group) / n
            var = _AllReduceSum.apply(
                (xf - mean.view(shape)).square().sum(dims), self.group) / n
        return self._normalize(x, mean, var), mean, var


@contextlib.contextmanager
def buffers_in_place(module: nn.Module) -> Iterator[None]:
    """Keep each buffer of ``module`` in the tensor that holds it now: a
    layer that replaces a buffer inside the block (a training
    :class:`BatchNorm` hands its running statistics on as new tensors,
    since autograd holds the old ones) has the new values copied into the
    old tensor at the end, and the old tensor put back. The values are the
    same; a CUDA graph's step needs its state at fixed addresses."""
    before = [(m, name, t) for m in module.modules()
              for name, t in m._buffers.items() if t is not None]
    yield
    with torch.no_grad():
        for m, name, old in before:
            new = m._buffers.get(name)
            if new is not old:
                old.copy_(new)
                m._buffers[name] = old


def adapt_batch_norm(module: nn.Module, x: torch.Tensor) -> None:
    """Set every :class:`BatchNorm`'s running statistics from its own input
    in one inference pass of ``module`` over ``x``, each layer after the
    ones before it: the mean, and the variance plus a quarter of the
    squared mean, so that a channel barely varying around a large mean is
    not blown up into its rounding noise. Gives randomly weighted models
    O(1) activations for testing."""
    def hook(bn, args):
        a = args[0].to(torch.float32)
        dims = [d for d in range(a.ndim) if d != 1]
        mean = a.mean(dims)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(a.var(dims, unbiased=False) + 0.25 * mean ** 2)

    hooks = [m.register_forward_pre_hook(hook) for m in module.modules()
             if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            module(x)
    finally:
        for h in hooks:
            h.remove()


def batch_norm(name: str, inp: str, features: int, momentum: float = 0.99,
               epsilon: float = 1e-3, scale: bool = True) -> LayerSpec:
    """Keras BatchNormalization defaults: momentum 0.99, epsilon 1e-3."""
    return LayerSpec(name=name, kind=KIND_BN, inputs=(inp,),
                     module_fn=lambda generator: BatchNorm(
                         features, momentum, epsilon, scale),
                     features=features)


class Normalization(_Float32State):
    """Keras ``layers.Normalization(axis=-1)``: ``(x - mean) /
    max(sqrt(variance), 1e-7)``, the statistics float32 buffers ``mean`` and
    ``variance`` (flax ``batch_stats``) cast to the input's dtype, as in the
    JAX layer; nothing updates them."""

    def __init__(self, mean: Sequence[float], variance: Sequence[float]):
        super().__init__()
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32))
        self.register_buffer("variance",
                             torch.tensor(variance, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1) if x.ndim == 4 else (1, -1)
        denom = torch.clamp(torch.sqrt(self.variance), min=1e-7)
        return ((x - self.mean.to(x.dtype).view(shape))
                / denom.to(x.dtype).view(shape))


def normalization(name: str, inp: str, mean: Sequence[float],
                  variance: Sequence[float]) -> LayerSpec:
    mean = tuple(float(m) for m in mean)
    variance = tuple(float(v) for v in variance)
    return LayerSpec(name=name, kind=KIND_NORM, inputs=(inp,),
                     module_fn=lambda generator: Normalization(mean,
                                                               variance),
                     features=len(mean))


def dense(name: str, inp: str, in_features: int, features: int,
          use_bias: bool = True,
          bias_init: Optional[Callable[[torch.Tensor], None]] = None,
          act: Optional[Callable] = None) -> LayerSpec:
    def factory(generator):
        return _keras_init(Linear(in_features, features, bias=use_bias),
                           generator, bias_init)
    return LayerSpec(name=name, kind=KIND_DENSE, inputs=(inp,),
                     module_fn=factory, post_fn=act, features=features)


class Dropout(nn.Module):
    """flax ``Dropout``: in training, each element kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``, drawn from the generator
    the forward is given; one keep/drop draw is shared along
    ``broadcast_dims`` (public NHWC axes), e.g. ``(1, 2, 3)`` drops whole
    samples (stochastic depth), ``(1, 2)`` whole channels
    (SpatialDropout2D). Identity when not training or at rate 0."""

    #: ``(index, count)``: under data parallelism the rank's batch is
    #: shard ``index`` of ``count`` equal shards of the global batch, and
    #: the mask is drawn for the global batch, this shard's rows kept.
    shard = (0, 1)

    def __init__(self, rate: float, broadcast_dims: Tuple[int, ...] = ()):
        super().__init__()
        self.rate, self.broadcast_dims = rate, tuple(broadcast_dims)

    def mask_shape(self, shape: Sequence[int]) -> List[int]:
        """The keep mask's shape for an input of ``shape`` (internal
        layout): 1 along the broadcast dims."""
        shape = list(shape)
        for d in self.broadcast_dims:
            shape[_INTERNAL_AXIS[d] if len(shape) == 4 else d] = 1
        return shape

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``, a boolean keep mask of :meth:`mask_shape`, replaces
        the draw."""
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        if mask is None:
            if generator is None:
                raise ValueError("dropout in training mode draws from an "
                                 "explicit generator: pass one to the "
                                 "forward")
            shape = self.mask_shape(x.shape)
            i, count = self.shard
            b, shape[0] = shape[0], shape[0] * count
            mask = torch.rand(shape, device=x.device,
                              generator=generator)[i * b:(i + 1) * b] < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def dropout_mask_shapes(module: "GraphModule", x: torch.Tensor
                        ) -> Dict[str, List[int]]:
    """The keep-mask shape (:meth:`Dropout.mask_shape`) of every dropout
    layer of ``module`` that draws in training, for one frame of ``x``'s
    shape (NHWC, batch axis first), found by an inference pass over one
    zero frame; a batch of B has B in place of the leading 1."""
    shapes: Dict[str, List[int]] = {}
    hooks = []
    for name, m in module.named_children():
        if isinstance(m, Dropout) and m.rate > 0.0:
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args, name=name: shapes.__setitem__(
                    name, mod.mask_shape(args[0].shape))))
    was_training = module.training
    try:
        with torch.no_grad():
            module.eval()(torch.zeros((1,) + tuple(x.shape[1:]),
                                      dtype=x.dtype, device=x.device))
    finally:
        module.train(was_training)
        for h in hooks:
            h.remove()
    return shapes


def dropout(name: str, inp: str, rate: float,
            broadcast_dims: Tuple[int, ...] = ()) -> LayerSpec:
    return LayerSpec(name=name, kind=KIND_DROPOUT, inputs=(inp,),
                     module_fn=lambda generator: Dropout(rate,
                                                         broadcast_dims))


def activation(name: str, inp: str, fn: Callable,
               op: Tuple[Any, ...] = ()) -> LayerSpec:
    """A layer computing ``fn`` of its input; ``op`` states it as data where
    ``fn`` is a closure (:class:`LayerSpec`)."""
    return LayerSpec(name=name, kind=KIND_FN, inputs=(inp,), fn=fn, op=op)


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
    """Max-pool; TF ``SAME`` pads with ``-inf`` (flax's ``reduce_window``
    init), so padding never wins the max."""
    window, strides = tuple(window), tuple(strides or window)
    if padding == "SAME":
        def fn(x):
            return F.max_pool2d(pad_same(x, window, strides, -math.inf),
                                window, strides)
    else:
        def fn(x):
            return F.max_pool2d(x, window, strides)
    return LayerSpec(name=name, kind=KIND_FN, inputs=(inp,), fn=fn,
                     op=("max_pool", window, strides, padding))


def avg_pool(name: str, inp: str, window: Tuple[int, int],
             strides: Optional[Tuple[int, int]] = None,
             padding: str = "VALID") -> LayerSpec:
    """Average pool; ``SAME`` pads with zeros that count in the average
    (flax ``avg_pool``'s ``count_include_pad=True``)."""
    window, strides = tuple(window), tuple(strides or window)
    same = padding == "SAME"
    return LayerSpec(
        name=name, kind=KIND_FN, inputs=(inp,),
        fn=lambda x: F.avg_pool2d(
            pad_same(x, window, strides) if same else x, window, strides),
        op=("avg_pool", window, strides, padding))


def global_avg_pool(name: str, inp: str) -> LayerSpec:
    return LayerSpec(name=name, kind=KIND_FN, inputs=(inp,),
                     fn=lambda x: x.mean(dim=(2, 3)),
                     op=("global_avg_pool",))


def zero_pad(name: str, inp: str,
             pad: Tuple[Tuple[int, int], Tuple[int, int]]) -> LayerSpec:
    """Keras ZeroPadding2D: ``((top, bottom), (left, right))``."""
    (top, bottom), (left, right) = pad
    return LayerSpec(name=name, kind=KIND_FN, inputs=(inp,),
                     fn=lambda x: pad_hw(x, (left, right, top, bottom)),
                     op=("zero_pad", top, bottom, left, right))


def add(name: str, a: str, b: str) -> LayerSpec:
    return LayerSpec(name=name, kind=KIND_FN, inputs=(a, b),
                     fn=lambda x, y: x + y, op=("add",))


def multiply(name: str, a: str, b: str) -> LayerSpec:
    return LayerSpec(name=name, kind=KIND_FN, inputs=(a, b),
                     fn=lambda x, y: x * y, op=("multiply",))


def input_node() -> LayerSpec:
    return LayerSpec(name=INPUT, kind=KIND_FN, inputs=(), fn=lambda: None)


def set_compute_dtype(module: nn.Module,
                      dtype: Optional[torch.dtype]) -> None:
    """The training form of mixed precision: every conv, dense and depthwise
    layer of ``module`` casts its weight, bias and input to ``dtype`` inside
    its forward (``None``: no cast), so the parameters stay in their own
    (float32) dtype and an optimizer updates them there. Batch norms are
    untouched: they normalize in float32 and return the input's dtype."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear, DepthwiseConv)):
            m.compute_dtype = dtype


def set_data_parallel(module: nn.Module, group=None) -> None:
    """Data parallelism over the process ``group`` (the mesh's ``data``
    axis; ``None``: none): every :class:`BatchNorm` of ``module`` takes
    its training statistics over the group's global batch and every
    :class:`Dropout` keeps its rank's rows of the global batch's mask (this
    rank's batch is shard ``rank in group`` of ``group``'s size)."""
    shard = ((0, 1) if group is None else
             (dist.get_rank(group), dist.get_world_size(group)))
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group
        elif isinstance(m, Dropout):
            m.shard = shard


def graph_of(*specs: LayerSpec, output: Optional[str] = None) -> LayerGraph:
    return LayerGraph(layers=(input_node(),) + tuple(specs),
                      output=output or specs[-1].name)
