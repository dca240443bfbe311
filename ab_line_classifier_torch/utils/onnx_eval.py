"""Minimal ONNX graph evaluator in numpy, for validating exports (the port's
copy of the JAX package's ``utils/onnx_eval.py``).

No ONNX runtime is installed, so an exported model
(``models/onnx_export.py``) is validated by executing the ONNX file with
this interpreter, written from the ONNX operator spec (NCHW Conv and pools,
explicit pads, numpy broadcasting) and independent of the port's graph that
produced the file: a layout or attribute fault in the exporter shows up as
a numerical mismatch rather than round-tripping silently.

Where the JAX package's copy calls ``lax`` for convolutions and pools,
this one is numpy alone: a convolution (and a MatMul) sums its products
in float64 and rounds once to float32, so it sits within float32 rounding
of the exact result whatever order the model's own convolution sums in;
pools pad with ``-inf`` (max) or zeros counted in the mean (average,
``count_include_pad``).

Supports the operator subset the exporters emit (opset 13 semantics).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ab_line_classifier_torch.utils import onnx_proto as OP

_CAST = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_,
         10: np.float16, 11: np.float64}


def _spatial_pads(attrs, n_sp: int) -> List[Tuple[int, int]]:
    pads = attrs.get("pads", [0] * (2 * n_sp))
    return [(int(pads[i]), int(pads[i + n_sp])) for i in range(n_sp)]


def _windows(x: np.ndarray, kernel, strides, dilations, out_hw):
    """``(tap index, view)`` of padded NCHW ``x`` for every kernel tap: the
    inputs that tap meets at each output position."""
    (kh, kw), (sh, sw), (dh, dw), (oh, ow) = kernel, strides, dilations, \
        out_hw
    for i in range(kh):
        for j in range(kw):
            yield (i, j), x[:, :, i * dh: i * dh + sh * (oh - 1) + 1: sh,
                            j * dw: j * dw + sw * (ow - 1) + 1: sw]


def _out_hw(x_hw, kernel, strides, dilations):
    return tuple((x_hw[a] - dilations[a] * (kernel[a] - 1) - 1)
                 // strides[a] + 1 for a in range(2))


def _conv(x: np.ndarray, w: np.ndarray, b: Optional[np.ndarray], attrs
          ) -> np.ndarray:
    """ONNX Conv, NCHW input, OIHW weight, explicit pads [h0, w0, h1,
    w1], ``group``."""
    group = int(attrs.get("group", 1))
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    dil = [int(d) for d in attrs.get("dilations", [1, 1])]
    x = np.pad(x.astype(np.float64),
               [(0, 0), (0, 0)] + _spatial_pads(attrs, 2))
    n, c = x.shape[:2]
    o, cg, kh, kw = w.shape
    out_hw = _out_hw(x.shape[2:], (kh, kw), strides, dil)
    wg = w.astype(np.float64).reshape(group, o // group, cg, kh, kw)
    out = np.zeros((n, group, o // group) + out_hw, np.float64)
    for (i, j), view in _windows(x, (kh, kw), strides, dil, out_hw):
        out += np.einsum("ngchw,goc->ngohw",
                         view.reshape(n, group, cg, *out_hw), wg[..., i, j],
                         optimize=True)
    out = out.reshape(n, o, *out_hw)
    if b is not None:
        out = out + b.astype(np.float64).reshape(1, -1, 1, 1)
    return out.astype(np.float32)


def _pool(x: np.ndarray, attrs, kind: str) -> np.ndarray:
    k = [int(v) for v in attrs["kernel_shape"]]
    # ONNX: strides default to 1 along each spatial axis (not to the kernel).
    strides = [int(v) for v in attrs.get("strides", [1] * len(k))]
    fill = -np.inf if kind == "max" else 0.0
    x = np.pad(x.astype(np.float32), [(0, 0), (0, 0)]
               + _spatial_pads(attrs, 2), constant_values=fill)
    out_hw = _out_hw(x.shape[2:], k, strides, (1, 1))
    out = None
    for _, view in _windows(x, k, strides, (1, 1), out_hw):
        if out is None:
            out = view.astype(np.float64 if kind == "avg" else np.float32)
        elif kind == "max":
            out = np.maximum(out, view)
        else:
            out = out + view
    if kind == "avg":
        out = out / float(np.prod(k))
    return out.astype(np.float32)


def evaluate(model, feeds: Dict[str, np.ndarray],
             outputs: Optional[List[str]] = None) -> List[np.ndarray]:
    """Run the graph on the given input feeds; returns the outputs."""
    g = model.graph
    env: Dict[str, np.ndarray] = dict(OP.initializer_arrays(g))
    env.update({k: np.asarray(v) for k, v in feeds.items()})

    for node in g.node:
        attrs = OP.node_attrs(node)
        ins = [env[n] if n else None for n in node.input]
        op = node.op_type
        if op in ("Add", "Sub", "Mul", "Div", "Pow", "Max", "Min"):
            fn = {"Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
                  "Div": np.divide, "Pow": np.power, "Max": np.maximum,
                  "Min": np.minimum}[op]
            out = fn(ins[0], ins[1])
        elif op == "Neg":
            out = -ins[0]
        elif op == "Sqrt":
            out = np.sqrt(ins[0])
        elif op == "Reciprocal":
            out = 1.0 / ins[0]
        elif op == "Exp":
            out = np.exp(ins[0])
        elif op == "Log":
            out = np.log(ins[0])
        elif op == "Tanh":
            out = np.tanh(ins[0])
        elif op == "Sigmoid":
            out = 1.0 / (1.0 + np.exp(-ins[0].astype(np.float64)))
            out = out.astype(np.float32)
        elif op == "Abs":
            out = np.abs(ins[0])
        elif op == "Clip":
            lo = ins[1] if len(ins) > 1 and ins[1] is not None else None
            hi = ins[2] if len(ins) > 2 and ins[2] is not None else None
            out = np.clip(ins[0], lo, hi)
        elif op == "Where":
            out = np.where(ins[0], ins[1], ins[2])
        elif op == "Identity":
            out = ins[0]
        elif op == "IsInf":
            out = np.isinf(ins[0])
        elif op == "IsNaN":
            out = np.isnan(ins[0])
        elif op == "Or":
            out = np.logical_or(ins[0], ins[1])
        elif op == "And":
            out = np.logical_and(ins[0], ins[1])
        elif op == "Not":
            out = np.logical_not(ins[0])
        elif op == "Cast":
            out = ins[0].astype(_CAST[int(attrs["to"])])
        elif op == "Reshape":
            out = ins[0].reshape([int(s) for s in ins[1]])
        elif op == "Transpose":
            out = np.transpose(ins[0], attrs["perm"])
        elif op == "Expand":
            out = np.broadcast_to(ins[0], [int(s) for s in ins[1]]).copy()
        elif op == "Pad":
            pads = [int(p) for p in ins[1]]
            n = ins[0].ndim
            cval = (float(np.asarray(ins[2]).reshape(-1)[0])
                    if len(ins) > 2 and ins[2] is not None else 0.0)
            width = [(pads[i], pads[i + n]) for i in range(n)]
            out = np.pad(ins[0], width, constant_values=cval)
        elif op == "Concat":
            out = np.concatenate(ins, axis=int(attrs["axis"]))
        elif op == "MatMul":
            out = (ins[0].astype(np.float64) @ ins[1].astype(np.float64)
                   ).astype(np.result_type(ins[0], ins[1]))
        elif op == "Gemm":
            a = ins[0].T if int(attrs.get("transA", 0)) else ins[0]
            b = ins[1].T if int(attrs.get("transB", 0)) else ins[1]
            out = (float(attrs.get("alpha", 1.0)) * (a @ b))
            if len(ins) > 2 and ins[2] is not None:
                out = out + float(attrs.get("beta", 1.0)) * ins[2]
        elif op == "Einsum":
            out = np.einsum(attrs["equation"], *ins)
        elif op == "ReduceSum":
            axes = tuple(int(a) for a in ins[1]) if len(ins) > 1 else None
            out = np.sum(ins[0], axis=axes,
                         keepdims=bool(attrs.get("keepdims", 1)))
        elif op in ("ReduceMax", "ReduceMin", "ReduceProd", "ReduceMean"):
            fn = {"ReduceMax": np.max, "ReduceMin": np.min,
                  "ReduceProd": np.prod, "ReduceMean": np.mean}[op]
            axes = tuple(int(a) for a in attrs.get("axes", []))
            out = fn(ins[0], axis=axes or None,
                     keepdims=bool(attrs.get("keepdims", 1)))
        elif op == "Conv":
            out = _conv(ins[0], ins[1],
                        ins[2] if len(ins) > 2 else None, attrs)
        elif op == "MaxPool":
            out = _pool(ins[0], attrs, "max")
        elif op == "AveragePool":
            out = _pool(ins[0], attrs, "avg")
        elif op == "BatchNormalization":
            x, scale, bias, mean, var = ins[:5]
            eps = float(attrs.get("epsilon", 1e-5))
            shape = (1, -1) + (1,) * (x.ndim - 2)
            out = ((x - mean.reshape(shape))
                   / np.sqrt(var.reshape(shape) + eps)
                   * scale.reshape(shape) + bias.reshape(shape))
        elif op == "Relu":
            out = np.maximum(ins[0], 0)
        elif op == "Softmax":
            ax = int(attrs.get("axis", -1))  # opset-13 default
            z = ins[0] - ins[0].max(axis=ax, keepdims=True)
            e = np.exp(z)
            out = e / e.sum(axis=ax, keepdims=True)
        elif op == "GlobalAveragePool":
            out = ins[0].mean(axis=tuple(range(2, ins[0].ndim)),
                              keepdims=True)
        elif op == "Flatten":
            out = ins[0].reshape(ins[0].shape[0], -1)
        elif op == "Dropout":
            out = ins[0]
        else:
            raise NotImplementedError(f"evaluator has no op {node.op_type}")
        env[node.output[0]] = np.asarray(out)

    names = outputs or [o.name for o in g.output]
    return [env[n] for n in names]
