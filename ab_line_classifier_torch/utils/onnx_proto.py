"""Dependency-free ONNX protobuf IO (the port's copy of the JAX package's
``utils/onnx_proto.py``).

Restoring a ``.onnx`` checkpoint is a *weight importer*: the initializers
(and the node topology that gives each initializer its semantic role) are
read straight from the protobuf with a checked-in subset of the official
schema (``utils/onnx_minimal_pb2.py``, field-number-exact, so real exporter
files parse; unknown fields are skipped by the protobuf runtime). No ONNX
package or runtime is needed.

This module holds the low-level pieces: load/save ModelProto and numpy <->
TensorProto conversion. The layer mapping lives in
``models/onnx_weights.py``. protobuf is imported on first use, not when the
module is imported.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ab_line_classifier_torch.utils.onnx_minimal_pb2 import messages


def _dtypes() -> Dict[int, type]:
    """TensorProto.DataType -> numpy dtype (the subset that appears as
    weights)."""
    T = messages().TensorProto
    return {
        T.FLOAT: np.float32,
        T.UINT8: np.uint8,
        T.INT8: np.int8,
        T.UINT16: np.uint16,
        T.INT16: np.int16,
        T.INT32: np.int32,
        T.INT64: np.int64,
        T.BOOL: np.bool_,
        T.FLOAT16: np.float16,
        T.DOUBLE: np.float64,
        T.UINT32: np.uint32,
        T.UINT64: np.uint64,
    }


def load_model(path: str):
    """Parse a .onnx file into the minimal ModelProto."""
    model = messages().ModelProto()
    with open(path, "rb") as f:
        model.ParseFromString(f.read())
    return model


def save_model(model, path: str) -> None:
    with open(path, "wb") as f:
        f.write(model.SerializeToString())


def tensor_to_array(t) -> np.ndarray:
    """TensorProto -> numpy array (raw_data or the typed repeated fields)."""
    T = messages().TensorProto
    dims = tuple(t.dims)
    if t.data_type == T.BFLOAT16:
        # no numpy bfloat16: widen via uint16 bit pattern -> float32
        if t.raw_data:
            bits = np.frombuffer(t.raw_data, np.uint16)
        else:
            bits = np.asarray(t.int32_data, np.uint16)
        return (bits.astype(np.uint32) << 16).view(np.float32).reshape(dims)
    dtype = _dtypes().get(t.data_type)
    if dtype is None:
        raise ValueError(f"unsupported tensor data_type {t.data_type} "
                         f"for initializer {t.name!r}")
    if t.raw_data:
        return np.frombuffer(t.raw_data, dtype).reshape(dims).copy()
    if t.data_type == T.FLOAT:
        data = np.asarray(t.float_data, np.float32)
    elif t.data_type == T.DOUBLE:
        data = np.asarray(t.double_data, np.float64)
    elif t.data_type == T.INT64:
        data = np.asarray(t.int64_data, np.int64)
    elif t.data_type in (T.UINT32, T.UINT64):
        data = np.asarray(t.uint64_data, np.uint64).astype(dtype)
    else:  # int32_data holds int32/16/8, uint16/8, bool, float16 (as bits)
        if t.data_type == T.FLOAT16:
            data = np.asarray(t.int32_data, np.uint16).view(np.float16)
        else:
            data = np.asarray(t.int32_data, np.int32).astype(dtype)
    return data.reshape(dims)


def array_to_tensor(a: np.ndarray, name: str):
    """numpy array -> TensorProto (raw_data encoding)."""
    T = messages().TensorProto
    a = np.ascontiguousarray(a)
    rev = {v: k for k, v in _dtypes().items()}
    dt = rev.get(a.dtype.type)
    if dt is None:
        a = a.astype(np.float32)
        dt = T.FLOAT
    t = T(name=name, data_type=dt)
    t.dims.extend(a.shape)
    t.raw_data = a.tobytes()
    return t


def initializer_arrays(graph) -> Dict[str, np.ndarray]:
    """All graph initializers as {name: ndarray}."""
    return {t.name: tensor_to_array(t) for t in graph.initializer}


def node_attrs(node) -> Dict[str, object]:
    """Node attributes as a plain dict (scalar int/float/string + ints)."""
    A = messages().AttributeProto
    out: Dict[str, object] = {}
    for a in node.attribute:
        if a.type == A.INT:
            out[a.name] = int(a.i)
        elif a.type == A.FLOAT:
            out[a.name] = float(a.f)
        elif a.type == A.STRING:
            out[a.name] = a.s.decode("utf-8", "replace")
        elif a.type == A.INTS:
            out[a.name] = [int(v) for v in a.ints]
        elif a.type == A.FLOATS:
            out[a.name] = [float(v) for v in a.floats]
    return out
