"""Experiment tracking, local-first (port of the JAX package's
``train/tracker.py``).

``LocalTracker`` writes one directory per run under ``TRACKER.DIR``:
``events.jsonl`` (timestamped epoch and metric events; the first,
``start``, names the run's group, a sweep's or k-fold run's id, and its
job type), ``config.json`` (the hyperparameters with a trial's overrides,
and ``FOLD_ID``) and, from :meth:`LocalTracker.finish`, ``summary.json``.
``TRACKER.BACKEND: wandb`` logs to a W&B run (:class:`WandbTracker`) and
``tensorboard`` to event files under ``PATHS.LOGS/<run>``
(:class:`TensorBoardTracker`), with the same event names
(``epoch/<k>``, ``epoch/val_<k>``, ``epoch/lr``, ``<name>/<k>``); where
the backend does not import, :func:`make_tracker` says so and tracks
locally. wandb and tensorboard are imported only by those trackers.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, Optional

import numpy as np

from ab_line_classifier_torch.parallel.mesh import is_main


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


class WandbTracker(NullTracker):
    """A W&B run (the reference's own tracker); ``wandb_module`` stands in
    for the ``wandb`` module (the default imports it)."""

    def __init__(self, project: str, entity: Optional[str] = None,
                 group: Optional[str] = None, job_type: str = "train",
                 config: Optional[Dict] = None, wandb_module=None):
        if wandb_module is None:
            import wandb as wandb_module
        self._wandb = wandb_module
        self.run = wandb_module.init(project=project, entity=entity or None,
                                     group=group, job_type=job_type,
                                     config=config)
        self.run_dir = self.run.dir

    def log_config(self, config: Dict[str, Any]) -> None:
        self.run.config.update(config, allow_val_change=True)

    def log_epoch(self, log) -> None:
        payload = {f"epoch/{k}": v for k, v in log.train.items()}
        payload.update({f"epoch/val_{k}": v for k, v in log.val.items()})
        payload["epoch/lr"] = log.lr
        self._wandb.log(payload, step=log.epoch)

    def log_metrics(self, name: str, metrics: Dict[str, Any]) -> None:
        self._wandb.log({f"{name}/{k}": v for k, v in metrics.items()})

    def log_image(self, name: str, image, step: Optional[int] = None) -> None:
        self._wandb.log({name: self._wandb.Image(_as_image_array(image))},
                        step=step)

    def finish(self, summary: Optional[Dict[str, Any]] = None) -> None:
        if summary:
            for k, v in summary.items():
                self.run.summary[k] = v
        self.run.finish()


class TensorBoardTracker(NullTracker):
    """TensorBoard event files under ``<log_root>/<run>`` (the reference's
    legacy trainer's ``results/logs/{timestamp}``); scalars by epoch."""

    def __init__(self, log_root: str, run_name: Optional[str] = None):
        from torch.utils.tensorboard import SummaryWriter

        ts = time.strftime("%Y%m%d-%H%M%S")
        self.run_id = run_name or f"{ts}-{uuid.uuid4().hex[:6]}"
        self.run_dir = os.path.join(log_root, self.run_id)
        self._writer = SummaryWriter(self.run_dir)

    def log_config(self, config: Dict[str, Any]) -> None:
        self._writer.add_text("config", json.dumps(
            {k: _jsonable(v) for k, v in config.items()}, indent=2))

    def log_epoch(self, log) -> None:
        for k, v in log.train.items():
            self._writer.add_scalar(f"epoch/{k}", v, log.epoch)
        for k, v in log.val.items():
            self._writer.add_scalar(f"epoch/val_{k}", v, log.epoch)
        if log.lr is not None:
            self._writer.add_scalar("epoch/lr", log.lr, log.epoch)

    def log_metrics(self, name: str, metrics: Dict[str, Any]) -> None:
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self._writer.add_scalar(f"{name}/{k}", v)

    def log_image(self, name: str, image, step: Optional[int] = None) -> None:
        self._writer.add_image(name, _as_image_array(image),
                               global_step=step or 0, dataformats="HWC")

    def finish(self, summary: Optional[Dict[str, Any]] = None) -> None:
        if summary:
            self._writer.add_text("summary", json.dumps(
                {k: _jsonable(v) for k, v in summary.items()}, indent=2))
        self._writer.close()


def make_tracker(cfg, *, run_name: Optional[str] = None,
                 group: Optional[str] = None, job_type: str = "train"):
    """The tracker ``TRACKER.BACKEND`` selects (default local). A W&B or
    TensorBoard backend that cannot start (its package does not import)
    says why and tracks locally. Under a process group only rank 0
    tracks: the other ranks get a :class:`NullTracker`."""
    tcfg = cfg.get("TRACKER", {}) or {}
    backend = str(tcfg.get("BACKEND", "local")).lower()
    if backend == "none" or not is_main():
        return NullTracker()
    if backend == "wandb":
        try:
            wandb_cfg = cfg["WANDB"]
            return WandbTracker(project=wandb_cfg["PROJECT_NAME"],
                                entity=wandb_cfg.get("ENTITY"),
                                group=group, job_type=job_type)
        except Exception as e:
            print(f"wandb tracker unavailable ({e}); falling back to local")
    if backend == "tensorboard":
        try:
            log_root = cfg["PATHS"].get("LOGS", "results/logs/")
            return TensorBoardTracker(log_root, run_name=run_name)
        except Exception as e:
            print(f"tensorboard tracker unavailable ({e}); "
                  "falling back to local")
    return LocalTracker(tcfg.get("DIR", "results/runs/"), run_name=run_name,
                        group=group, job_type=job_type)
