"""ONNX model export (port of the JAX package's ``models/onnx_export.py``):
the port's layer graph -> an ONNX file, runtime-free.

The reference serves ``.onnx`` checkpoints on the WaveBase device; this
writes them. The JAX package converts a traced jaxpr primitive by
primitive; here the exporter walks the port's own :class:`LayerGraph`, one
ONNX sub-graph per layer kind, so every architecture of the zoo exports
without per-model code:

* conv (``Conv2d``; TF ``SAME`` at stride 2, ``SameConv2d``, with its
  asymmetric pads in ``pads``), depthwise (``Conv`` with ``group = C``) and
  separable (a depthwise ``Conv`` then the pointwise one), each with its
  bias as the ``Conv``'s third input and its fused activation after it;
* batch norm (``BatchNormalization``), ``Normalization`` (``(x - mean) /
  max(sqrt(variance), 1e-7)``), dense (``MatMul`` + ``Add``), dropout
  (identity: no node);
* the ``fn`` layers by their ``LayerSpec.op``: max pools (``MaxPool``,
  whose pads never win the max, as the port's ``-inf`` pads), average
  pools (``AveragePool``, pads counted), global average pools
  (``ReduceMean``), zero pads, adds, multiplies, the EfficientNet stem's
  rescalings and squeeze-excite reshape; activations by their ``fn``
  (relu, relu6, swish, sigmoid, the float32 softmax).

An unknown kind, ``op`` or activation raises :class:`ExportError`.

The file: opset 13; float32 input ``input_1`` ``[batch, H, W, 3]`` (NHWC,
preprocessed, the reference's ONNX serving contract), transposed once to
NCHW, where every node computes; the output ``[batch, n_classes]``
probabilities. Initializers are float32 (a bfloat16 or mixed-precision
model exports as float32), named as the JAX package names them,
``model/<layer>/<flax leaf>:0`` (the leaves of the weight bridge,
``utils/jax_params.flax_from_state_dict``), conv kernels OIHW, dense
kernels ``[in, out]``, so both packages' importers
(``models/onnx_weights.py``) read the file back by layer name, bit for
bit. The ``onnx`` package is not needed: the file is written through the
port's own schema (``utils/onnx_proto.py``), protobuf imported on first
use.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.models.common import ModelSpec
from ab_line_classifier_torch.models.mobilenet_v2 import relu6
from ab_line_classifier_torch.ops.padding import same_pads
from ab_line_classifier_torch.utils import onnx_proto as OP
from ab_line_classifier_torch.utils.jax_params import (
    flax_from_state_dict)
from ab_line_classifier_torch.utils.onnx_minimal_pb2 import messages

INPUT_NAME = "input_1"


class ExportError(NotImplementedError):
    pass


def _flat_leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
                 ) -> Dict[Tuple[str, ...], np.ndarray]:
    """``(layer, ..., leaf) -> array`` of a flax collection."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


class _Exporter:
    def __init__(self, leaves: Dict[Tuple[str, ...], np.ndarray]):
        M = messages()
        self.M = M
        self.model = M.ModelProto(ir_version=8, producer_name="ablc-torch")
        self.model.opset_import.add().version = 13
        self.g = self.model.graph
        self.g.name = "model"
        self.leaves = leaves
        self._uid = itertools.count()

    def fresh(self, hint: str) -> str:
        return f"{hint}_{next(self._uid)}"

    def const(self, arr, dtype=np.float32) -> str:
        name = self.fresh("const")
        self.g.initializer.append(OP.array_to_tensor(
            np.asarray(arr, dtype), name))
        return name

    def leaf(self, *path: str, layout: Callable = None) -> str:
        """The initializer of flax leaf ``path`` (layer, ..., leaf), named
        ``model/<path>:0``, stored in ``layout(array)``."""
        arr = self.leaves[path]
        name = "model/" + "/".join(path) + ":0"
        self.g.initializer.append(OP.array_to_tensor(
            np.ascontiguousarray(layout(arr) if layout else arr), name))
        return name

    def node(self, op_type: str, inputs: List[str], name: str,
             **attrs) -> str:
        A = self.M.AttributeProto
        n = self.g.node.add()
        n.op_type = op_type
        n.name = name
        n.input.extend(inputs)
        out = self.fresh(op_type.lower())
        n.output.append(out)
        for k, v in attrs.items():
            a = n.attribute.add()
            a.name = k
            if isinstance(v, int):
                a.i, a.type = v, A.INT
            elif isinstance(v, float):
                a.f, a.type = v, A.FLOAT
            elif isinstance(v, str):
                a.s, a.type = v.encode(), A.STRING
            elif isinstance(v, (list, tuple)):
                a.ints.extend(int(x) for x in v)
                a.type = A.INTS
            else:
                raise ExportError(f"attribute {k}={v!r}")
        return out


def _hwio_to_oihw(k: np.ndarray) -> np.ndarray:
    return k.transpose(3, 2, 0, 1)


def _conv_pads(layer: torch.nn.Module, in_hw: Tuple[int, int],
               kernel: Tuple[int, int], stride: Tuple[int, int]
               ) -> List[int]:
    """ONNX ``pads`` [top, left, bottom, right] of a conv-like layer: TF
    ``SAME`` from the input size (``SameConv2d``, a depthwise ``SAME``),
    else the module's own symmetric padding."""
    if isinstance(layer, G.SameConv2d) or getattr(layer, "padding",
                                                  None) == "SAME":
        (top, bottom), (left, right) = (
            same_pads(in_hw[0], kernel[0], stride[0]),
            same_pads(in_hw[1], kernel[1], stride[1]))
        return [top, left, bottom, right]
    if isinstance(layer, G.DepthwiseConv):
        return [0, 0, 0, 0]
    ph, pw = layer.padding
    return [ph, pw, ph, pw]


def _activation(ex: _Exporter, fn: Callable, x: str, name: str) -> str:
    if fn in (F.relu, torch.relu):
        return ex.node("Relu", [x], name)
    if fn is relu6:
        return ex.node("Clip", [x, ex.const(0.0), ex.const(6.0)], name)
    if fn in (F.silu,):
        return ex.node("Mul", [x, ex.node("Sigmoid", [x], name + "/gate")],
                       name)
    if fn in (torch.sigmoid, F.sigmoid):
        return ex.node("Sigmoid", [x], name)
    if fn is G._softmax_f32:
        return ex.node("Softmax", [x], name, axis=-1)
    raise ExportError(f"{name}: no ONNX mapping for activation {fn!r}")


def _export_layer(ex: _Exporter, spec: G.LayerSpec, layer, ins: List[str],
                  in_shapes: List[Tuple[int, ...]], batch: int) -> str:
    """The ONNX value of layer ``spec`` (inputs ``ins``, NCHW, public
    shapes ``in_shapes`` at batch 1)."""
    name, kind = spec.name, spec.kind
    x = ins[0] if ins else None
    in_hw = tuple(in_shapes[0][1:3]) if in_shapes else ()
    if kind == G.KIND_DROPOUT:
        return x
    if kind == G.KIND_CONV and isinstance(layer, G.SeparableConv):
        dw = layer.depthwise
        k = tuple(dw.weight.shape[2:])
        x = ex.node("Conv", [x, ex.leaf(name, "depthwise", "kernel",
                                        layout=_hwio_to_oihw)],
                    f"{name}/depthwise", kernel_shape=k,
                    strides=[dw.stride] * 2, group=dw.weight.shape[0],
                    pads=_conv_pads(dw, in_hw, k, (dw.stride,) * 2))
        pw = [x, ex.leaf(name, "pointwise", "kernel", layout=_hwio_to_oihw)]
        if layer.pointwise.bias is not None:
            pw.append(ex.leaf(name, "pointwise", "bias"))
        return ex.node("Conv", pw, f"{name}/pointwise", kernel_shape=[1, 1])
    if kind in (G.KIND_CONV, G.KIND_DEPTHWISE):
        if isinstance(layer, G.DepthwiseConv):
            k, stride = tuple(layer.weight.shape[2:]), (layer.stride,) * 2
            group = layer.weight.shape[0]
        elif isinstance(layer, G.Conv2d):
            k, stride, group = tuple(layer.kernel_size), layer.stride, 1
        else:
            raise ExportError(f"{name}: conv layer {type(layer).__name__}")
        args = [x, ex.leaf(name, "kernel", layout=_hwio_to_oihw)]
        if layer.bias is not None:
            args.append(ex.leaf(name, "bias"))
        y = ex.node("Conv", args, f"{name}/Conv", kernel_shape=k,
                    strides=stride, group=group,
                    pads=_conv_pads(layer, in_hw, k, stride))
        return (y if spec.post_fn is None
                else _activation(ex, spec.post_fn, y, f"{name}/act"))
    if kind == G.KIND_BN:
        scale = (ex.leaf(name, "scale") if layer.weight is not None
                 else ex.const(np.ones(layer.bias.shape)))
        return ex.node("BatchNormalization",
                       [x, scale, ex.leaf(name, "bias"),
                        ex.leaf(name, "mean"), ex.leaf(name, "var")],
                       f"{name}/BatchNormalization",
                       epsilon=float(layer.epsilon))
    if kind == G.KIND_NORM:
        shape = ex.const([1, -1, 1, 1] if len(in_shapes[0]) == 4
                         else [1, -1], np.int64)
        mean = ex.node("Reshape", [ex.leaf(name, "mean"), shape],
                       f"{name}/mean")
        var = ex.node("Reshape", [ex.leaf(name, "variance"), shape],
                      f"{name}/variance")
        denom = ex.node("Max", [ex.node("Sqrt", [var], f"{name}/Sqrt"),
                                ex.const(1e-7)], f"{name}/Max")
        return ex.node("Div", [ex.node("Sub", [x, mean], f"{name}/Sub"),
                               denom], f"{name}/Div")
    if kind == G.KIND_DENSE:
        if len(in_shapes[0]) != 2:
            raise ExportError(f"{name}: dense layer on a "
                              f"{len(in_shapes[0])}-D input")
        y = ex.node("MatMul", [x, ex.leaf(name, "kernel")], f"{name}/MatMul")
        if layer.bias is not None:
            y = ex.node("Add", [y, ex.leaf(name, "bias")], f"{name}/BiasAdd")
        return (y if spec.post_fn is None
                else _activation(ex, spec.post_fn, y, f"{name}/act"))
    if kind != G.KIND_FN:
        raise ExportError(f"{name}: no ONNX mapping for layer kind {kind!r}")
    if not spec.op:
        return _activation(ex, spec.fn, x, name)
    op, *args = spec.op
    if op in ("max_pool", "avg_pool"):
        window, strides, padding = args
        pads = [0, 0, 0, 0]
        if padding == "SAME":
            (top, bottom), (left, right) = (
                same_pads(in_hw[0], window[0], strides[0]),
                same_pads(in_hw[1], window[1], strides[1]))
            pads = [top, left, bottom, right]
        if op == "max_pool":
            return ex.node("MaxPool", [x], name, kernel_shape=window,
                           strides=strides, pads=pads)
        return ex.node("AveragePool", [x], name, kernel_shape=window,
                       strides=strides, pads=pads, count_include_pad=1)
    if op == "global_avg_pool":
        return ex.node("ReduceMean", [x], name, axes=[2, 3], keepdims=0)
    if op == "zero_pad":
        top, bottom, left, right = args
        return ex.node("Pad", [x, ex.const([0, 0, top, left, 0, 0, bottom,
                                            right], np.int64)], name,
                       mode="constant")
    if op == "add":
        return ex.node("Add", ins, name)
    if op == "multiply":
        return ex.node("Mul", ins, name)
    if op == "div":
        return ex.node("Div", [x, ex.const(args[0])], name)
    if op == "mul_channels":
        return ex.node("Mul", [x, ex.const(np.reshape(args[0],
                                                      (1, -1, 1, 1)))], name)
    if op == "expand_hw":
        return ex.node("Reshape", [x, ex.const(
            [batch, in_shapes[0][-1], 1, 1], np.int64)], name)
    raise ExportError(f"{name}: no ONNX mapping for op {spec.op!r}")


def export_onnx(spec: ModelSpec, state_dict: Dict[str, torch.Tensor],
                path: str, *, batch_size: int = 1):
    """Export ``spec``'s inference forward (softmax output) with the weights
    of ``state_dict`` to an ONNX file at ``path``, for a static batch of
    ``batch_size`` preprocessed float32 ``[batch, H, W, 3]`` frames.
    Returns the ``ModelProto`` (also written to ``path``)."""
    state = {k: v.detach().to("cpu", torch.float32)
             for k, v in state_dict.items()}
    variables = flax_from_state_dict(state)
    leaves = _flat_leaves(variables["params"])
    leaves.update(_flat_leaves(variables.get("batch_stats", {})))
    module = spec.module()
    module.load_state_dict(state)
    shapes = spec.layer_shapes(state)

    ex = _Exporter(leaves)
    gin = ex.g.input.add()
    gin.name = INPUT_NAME
    gin.type.tensor_type.elem_type = ex.M.TensorProto.FLOAT
    for d in (batch_size,) + tuple(spec.input_shape):
        gin.type.tensor_type.shape.dim.add().dim_value = int(d)
    values = {G.INPUT: ex.node("Transpose", [INPUT_NAME], "input_nchw",
                               perm=[0, 3, 1, 2])}
    for layer_spec in spec.graph.layers[1:]:
        values[layer_spec.name] = _export_layer(
            ex, layer_spec, module._modules.get(layer_spec.name),
            [values[i] for i in layer_spec.inputs],
            [shapes[i] for i in layer_spec.inputs], batch_size)

    out_shape = shapes[spec.graph.output]
    out = values[spec.graph.output]
    if len(out_shape) == 4:
        out = ex.node("Transpose", [out], "output_nhwc", perm=[0, 2, 3, 1])
    gout = ex.g.output.add()
    gout.name = out
    gout.type.tensor_type.elem_type = ex.M.TensorProto.FLOAT
    for d in (batch_size,) + tuple(out_shape[1:]):
        gout.type.tensor_type.shape.dim.add().dim_value = int(d)
    OP.save_model(ex.model, path)
    return ex.model
