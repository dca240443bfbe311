"""Experiment tracking, local-first (the ``NullTracker`` and
``LocalTracker`` of the JAX package's ``train/tracker.py``).

``LocalTracker`` writes one directory per run under ``TRACKER.DIR``:
``events.jsonl`` (timestamped epoch and metric events; the first,
``start``, names the run's group, a sweep's or k-fold run's id, and its
job type), ``config.json`` (the hyperparameters with a trial's overrides,
and ``FOLD_ID``) and, from :meth:`LocalTracker.finish`, ``summary.json``.
The W&B and TensorBoard backends wait for a later slice of the port:
selecting one says so and tracks locally, as the JAX package does when
its backend is not importable.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, Optional

import numpy as np


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


class NullTracker:
    run_dir = None

    def log_epoch(self, log) -> None:  # train.loop.EpochLog
        pass

    def log_metrics(self, name: str, metrics: Dict[str, Any]) -> None:
        pass

    def log_config(self, config: Dict[str, Any]) -> None:
        pass

    def log_image(self, name: str, image, step: Optional[int] = None) -> None:
        """Log a uint8 ``[H, W, 3]`` image or a matplotlib figure."""
        pass

    def finish(self, summary: Optional[Dict[str, Any]] = None) -> None:
        pass


def _as_image_array(image) -> np.ndarray:
    if hasattr(image, "canvas"):  # a matplotlib Figure
        image.canvas.draw()
        return np.asarray(image.canvas.buffer_rgba())[..., :3]
    return np.asarray(image)


class LocalTracker(NullTracker):
    """JSONL run logger, one directory per run."""

    def __init__(self, root: str, run_name: Optional[str] = None,
                 group: Optional[str] = None, job_type: str = "train"):
        ts = time.strftime("%Y%m%d-%H%M%S")
        # The suffix keeps runs started within one second apart.
        self.run_id = run_name or f"run{ts}-{uuid.uuid4().hex[:6]}"
        self.group = group
        self.job_type = job_type
        self.run_dir = os.path.join(root, self.run_id)
        os.makedirs(self.run_dir, exist_ok=True)
        self._events = open(os.path.join(self.run_dir, "events.jsonl"), "a")
        self._summary: Dict[str, Any] = {}
        self._t0 = time.time()
        self._emit({"event": "start", "group": group, "job_type": job_type})

    def _emit(self, payload: Dict[str, Any]) -> None:
        payload = {"ts": round(time.time() - self._t0, 3), **payload}
        self._events.write(json.dumps(payload, default=str) + "\n")
        self._events.flush()

    def log_config(self, config: Dict[str, Any]) -> None:
        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            json.dump({k: _jsonable(v) for k, v in config.items()}, f,
                      indent=2)

    def log_epoch(self, log) -> None:
        self._emit({
            "event": "epoch", "epoch": log.epoch, "phase": log.phase,
            "lr": log.lr, "seconds": round(log.seconds, 3),
            **{f"train/{k}": v for k, v in log.train.items()},
            **{f"val/{k}": v for k, v in log.val.items()},
        })
        self._summary.update({f"epoch/{k}": v for k, v in log.train.items()})
        self._summary.update(
            {f"epoch/val_{k}": v for k, v in log.val.items()})

    def log_metrics(self, name: str, metrics: Dict[str, Any]) -> None:
        self._emit({"event": name,
                    **{k: _jsonable(v) for k, v in metrics.items()}})
        self._summary.update(
            {f"{name}/{k}": _jsonable(v) for k, v in metrics.items()})

    def log_image(self, name: str, image, step: Optional[int] = None) -> None:
        from PIL import Image

        img_dir = os.path.join(self.run_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        suffix = f"_{step}" if step is not None else ""
        path = os.path.join(img_dir, f"{name}{suffix}.png")
        Image.fromarray(_as_image_array(image).astype("uint8")).save(path)
        self._emit({"event": "image", "name": name, "step": step,
                    "path": os.path.relpath(path, self.run_dir)})

    def finish(self, summary: Optional[Dict[str, Any]] = None) -> None:
        if summary:
            self._summary.update(
                {k: _jsonable(v) for k, v in summary.items()})
        with open(os.path.join(self.run_dir, "summary.json"), "w") as f:
            json.dump(self._summary, f, indent=2)
        self._emit({"event": "finish"})
        self._events.close()


def make_tracker(cfg, *, run_name: Optional[str] = None,
                 group: Optional[str] = None, job_type: str = "train"):
    """The tracker ``TRACKER.BACKEND`` selects (default local)."""
    tcfg = cfg.get("TRACKER", {}) or {}
    backend = str(tcfg.get("BACKEND", "local")).lower()
    if backend == "none":
        return NullTracker()
    if backend != "local":
        print(f"tracker backend {backend!r} is not ported yet; tracking "
              f"locally")
    return LocalTracker(tcfg.get("DIR", "results/runs/"), run_name=run_name,
                        group=group, job_type=job_type)
