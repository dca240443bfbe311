"""Atomic single-file mid-training checkpoints (resume), the port of the
JAX package's ``utils/resume.py`` for one process.

Tensors and host-side progress go into ONE file (two files can
desynchronize when a kill lands between their writes, and a resumed run
would then re-apply an epoch to post-epoch weights). The file is
``torch.save``d to a temporary path, fsynced, and ``os.replace``d over the
previous one, so a kill at any moment leaves the old complete checkpoint
or the new one. Syncing the file across processes waits for the parallel
training slice.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch


def save_resume(dir_path: str, filename: str, payload: Dict[str, Any],
                progress: Dict[str, Any]) -> None:
    """Atomically persist ``payload`` (tensors in dicts and lists, numbers,
    ``None``) plus ``progress`` (JSON-able host state) as one file."""
    os.makedirs(dir_path, exist_ok=True)
    final = os.path.join(dir_path, filename)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        torch.save({"payload": payload, "progress": json.dumps(progress)}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def load_resume(dir_path: Optional[str], filename: str
                ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """``(payload, progress)`` of a checkpoint written by
    :func:`save_resume`, tensors on the CPU, or ``None`` when there is
    none."""
    if not dir_path:
        return None
    path = os.path.join(dir_path, filename)
    if not os.path.isfile(path):
        return None
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return blob["payload"], json.loads(blob["progress"])
