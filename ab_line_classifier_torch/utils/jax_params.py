"""Weight bridge between the JAX package's variable tree and the port's
state dict.

The JAX side is a ``{"params": {...}, "batch_stats": {...}}`` tree of numpy
arrays, keyed by Keras layer name (convert device arrays with
``np.asarray`` first). The port's state dict uses the same layer names:

* conv ``kernel`` HWIO ``[kh, kw, in, out]`` -> ``<layer>.weight`` OIHW; a
  depthwise ``kernel [K, K, 1, C]`` is the same transpose, to the grouped
  conv's ``[C, 1, K, K]``;
* a transposed conv's ``kernel`` (flax ``ConvTranspose`` with
  ``transpose_kernel=True``, the U-Net's ``dec*_up``), stored as Keras's
  ``(kh, kw, out, in)``, takes the same transpose to
  ``ConvTranspose2d.weight`` ``(in, out, kh, kw)``, with no spatial flip:
  both are the gradient of a convolution;
* dense ``kernel`` ``[in, out]`` -> ``<layer>.weight`` ``[out, in]``;
* batch-norm ``scale`` -> ``<layer>.weight``; every ``bias`` ->
  ``<layer>.bias``;
* ``batch_stats``: a batch norm's ``mean`` / ``var`` -> the
  ``running_mean`` / ``running_var`` buffers, a ``Normalization``'s
  ``mean`` / ``variance`` -> its ``mean`` / ``variance`` buffers.

Nested layers (a separable conv's ``depthwise`` / ``pointwise``) become
dotted keys. This module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# batch_stats leaf -> buffer name, for a layer whose stats hold a "var"
# (batch norm) and for one that does not (Normalization).
_BN_STATS = {"mean": "running_mean", "var": "running_var"}
_NORM_STATS = {"mean": "mean", "variance": "variance"}
_STATS_LEAF = {"running_mean": "mean", "running_var": "var",
               "mean": "mean", "variance": "variance"}


def _walk(prefix: str, tree: Mapping[str, Any], leaf_fn) -> None:
    for name, value in tree.items():
        key = f"{prefix}.{name}" if prefix else name
        if isinstance(value, Mapping):
            _walk(key, value, leaf_fn)
        else:
            leaf_fn(prefix, name, np.asarray(value), tree)


def state_dict_from_flax(variables: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """JAX ``{params, batch_stats}`` numpy tree -> port state dict."""
    out: Dict[str, torch.Tensor] = {}

    def put(prefix: str, name: str, a: np.ndarray) -> None:
        out[f"{prefix}.{name}"] = torch.from_numpy(np.ascontiguousarray(a))

    def param(prefix, name, a, siblings):
        if name == "kernel" and a.ndim in (2, 4):
            put(prefix, "weight", a.T if a.ndim == 2
                else a.transpose(3, 2, 0, 1))
        elif name == "scale" and a.ndim == 1:
            put(prefix, "weight", a)
        elif name == "bias":
            put(prefix, "bias", a)
        else:
            raise ValueError(f"no torch counterpart for leaf "
                             f"{prefix}.{name} of shape {a.shape}")

    def stat(prefix, name, a, siblings):
        names = _BN_STATS if "var" in siblings else _NORM_STATS
        if name not in names:
            raise ValueError(f"no torch counterpart for batch_stats leaf "
                             f"{prefix}.{name}")
        put(prefix, names[name], a)

    _walk("", variables["params"], param)
    _walk("", variables.get("batch_stats") or {}, stat)
    return out


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor]
                         ) -> Dict[str, Any]:
    """Port state dict -> JAX ``{"params": ..., "batch_stats": ...}`` numpy
    tree (the inverse of :func:`state_dict_from_flax`; ``batch_stats`` only
    when the model has statistics). bfloat16 tensors come back as
    float32."""
    tree: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        a = t.numpy()
        collection = "params"
        if leaf == "weight" and a.ndim in (2, 4):
            a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)
            leaf = "kernel"
        elif leaf == "weight" and a.ndim == 1:
            leaf = "scale"
        elif leaf in _STATS_LEAF:
            collection, leaf = "batch_stats", _STATS_LEAF[leaf]
        elif leaf != "bias":
            raise ValueError(f"no JAX counterpart for {key!r} of shape "
                             f"{a.shape}")
        node = tree[collection]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return {k: v for k, v in tree.items() if v or k == "params"}
