"""Weight bridge between the JAX package's variable tree and the port's
state dict.

The JAX side is a ``{"params": {...}, "batch_stats": {...}}`` tree of numpy
arrays, keyed by Keras layer name (convert device arrays with
``np.asarray`` first). The port's state dict uses the same layer names:

* conv ``kernel`` HWIO ``[kh, kw, in, out]`` -> ``<layer>.weight`` OIHW;
* dense ``kernel`` ``[in, out]`` -> ``<layer>.weight`` ``[out, in]``;
* ``bias`` -> ``<layer>.bias``.

Nested layers (a separable conv's ``depthwise`` / ``pointwise``) become
dotted keys. Batch-norm statistics come with the models that have them.
This module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def state_dict_from_flax(variables: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """JAX ``{params, batch_stats}`` numpy tree -> port state dict."""
    if variables.get("batch_stats"):
        raise NotImplementedError(
            "batch_stats (BatchNorm) come with the zoo slice of the port "
            "(ROADMAP Queue A item 8)")
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, tree: Mapping[str, Any]) -> None:
        for name, value in tree.items():
            key = f"{prefix}.{name}" if prefix else name
            if isinstance(value, Mapping):
                walk(key, value)
                continue
            a = np.asarray(value)
            if name == "kernel" and a.ndim in (2, 4):
                a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
                key = f"{prefix}.weight"
            elif name != "bias":
                raise ValueError(f"no torch counterpart for leaf {key!r} "
                                 f"of shape {a.shape}")
            out[key] = torch.from_numpy(np.ascontiguousarray(a))

    walk("", variables["params"])
    return out


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor]
                         ) -> Dict[str, Any]:
    """Port state dict -> JAX ``{"params": ...}`` numpy tree (the inverse of
    :func:`state_dict_from_flax`). bfloat16 tensors come back as float32."""
    params: Dict[str, Any] = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        a = t.numpy()
        if leaf == "weight" and a.ndim in (2, 4):
            a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)
            leaf = "kernel"
        elif leaf != "bias":
            raise ValueError(f"no JAX counterpart for {key!r} of shape "
                             f"{a.shape}")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return {"params": params}
