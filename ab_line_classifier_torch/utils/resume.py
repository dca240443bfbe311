"""Atomic single-file mid-training checkpoints (resume), the port of the
JAX package's ``utils/resume.py``.

Tensors and host-side progress go into ONE file (two files can
desynchronize when a kill lands between their writes, and a resumed run
would then re-apply an epoch to post-epoch weights). The file is
``torch.save``d to a temporary path, fsynced, and ``os.replace``d over the
previous one, so a kill at any moment leaves the old complete checkpoint
or the new one.

Under a process group only rank 0 writes, and :func:`load_resume`
broadcasts rank 0's bytes, or their absence, to every rank: with a
checkpoint directory local to one host the others see no file, and each
deciding alone whether to resume would leave the ranks running different
collectives.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ab_line_classifier_torch.parallel import mesh as mesh_lib


def save_resume(dir_path: str, filename: str, payload: Dict[str, Any],
                progress: Dict[str, Any]) -> None:
    """Atomically persist ``payload`` (tensors in dicts and lists, numbers,
    ``None``) plus ``progress`` (JSON-able host state) as one file; on
    rank 0 only."""
    if not mesh_lib.is_main():
        return
    os.makedirs(dir_path, exist_ok=True)
    final = os.path.join(dir_path, filename)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        torch.save({"payload": payload, "progress": json.dumps(progress)}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def _sync_blob(blob: Optional[bytes]) -> Optional[bytes]:
    """Rank 0's checkpoint bytes (or ``None``) on every rank: the length,
    then the bytes, broadcast from rank 0."""
    if mesh_lib.world_size() == 1:
        return blob
    dev = mesh_lib.backend_device()
    main = mesh_lib.is_main()
    length = torch.tensor([len(blob) if main and blob is not None else -1],
                          dtype=torch.int64, device=dev)
    dist.broadcast(length, 0)
    n = int(length.item())
    if n < 0:
        return None
    buf = (torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(dev)
           if main else torch.empty(n, dtype=torch.uint8, device=dev))
    dist.broadcast(buf, 0)
    return buf.cpu().numpy().tobytes()


def load_resume(dir_path: Optional[str], filename: str
                ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """``(payload, progress)`` of a checkpoint written by
    :func:`save_resume`, tensors on the CPU, or ``None`` when there is
    none; under a process group, rank 0's on every rank (a checkpoint
    only another rank sees is ignored: the decision has one authority).
    Every rank calls it."""
    blob = None
    if dir_path and mesh_lib.is_main():
        path = os.path.join(dir_path, filename)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                blob = f.read()
    blob = _sync_blob(blob)
    if blob is None:
        return None
    data = torch.load(io.BytesIO(blob), map_location="cpu",
                      weights_only=True)
    return data["payload"], json.loads(data["progress"])
