"""Model serialization for the port: the ``results/models/`` contract of
the JAX package's ``utils/checkpoint.py`` with a PyTorch state.

A checkpoint is a directory ``results/models/model{timestamp}/`` holding

* ``state.pt`` — the model's tensor state dict (``torch.save``),
* ``meta.json`` — model name, hyperparameters, input shape, classes,
  preprocess mode and ``mixed_precision``, so ``restore`` can rebuild the
  exact ModelSpec.

``meta.json`` is written last and is the commit marker. A path that is not
a checkpoint but a directory of them (or ``.../latest``) resolves to the
newest. The JAX package's Orbax directories are not readable here without
Orbax: ``scripts/orbax_to_torch.py`` converts one, where JAX is installed.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

META_NAME = "meta.json"
STATE_NAME = "state.pt"


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def _write_atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_model(model_dir: str, state_dict: Dict[str, torch.Tensor],
               meta: Dict[str, Any]) -> str:
    """Write ``state.pt`` then ``meta.json``, each through tmp+rename, so a
    crash mid-save never leaves a directory that :func:`is_model_dir`
    accepts but :func:`load_model` cannot restore."""
    model_dir = os.path.abspath(model_dir)
    os.makedirs(model_dir, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in state_dict.items()}
    _write_atomic(os.path.join(model_dir, STATE_NAME),
                  lambda f: torch.save(state, f))
    _write_atomic(os.path.join(model_dir, META_NAME),
                  lambda f: f.write(json.dumps(
                      meta, indent=2, default=_json_default).encode()))
    return model_dir


def is_model_dir(path: str) -> bool:
    return (os.path.isfile(os.path.join(path, META_NAME))
            and os.path.isfile(os.path.join(path, STATE_NAME)))


def resolve_model_dir(path: str) -> str:
    """Resolve ``MODEL_TO_LOAD``: an exact checkpoint dir, or a directory of
    checkpoints (newest wins), or a ``.../latest`` alias to the newest
    checkpoint in the parent directory."""
    path = os.path.abspath(path)
    if is_model_dir(path):
        return path
    search = path
    if not os.path.isdir(path) and os.path.basename(path) == "latest":
        search = os.path.dirname(path)
    if os.path.isdir(search):
        candidates = [os.path.join(search, d) for d in os.listdir(search)]
        candidates = [c for c in candidates if is_model_dir(c)]
        if candidates:
            return max(candidates, key=os.path.getmtime)
    raise FileNotFoundError(f"no model checkpoint found at {path!r}")


def load_model(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Returns ``(state_dict, meta)``, tensors on the CPU."""
    model_dir = resolve_model_dir(path)
    with open(os.path.join(model_dir, META_NAME)) as f:
        meta = json.load(f)
    state = torch.load(os.path.join(model_dir, STATE_NAME),
                       map_location="cpu", weights_only=True)
    return state, meta
