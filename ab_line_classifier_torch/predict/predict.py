"""Inference: frame predictions, clip predictions, metrics/CSV contracts
(port of the JAX package's ``predict/predict.py``).

* :class:`Predictor` restores a port checkpoint and serves uint8 frames:
  every forward preprocesses through ``ops.preprocess_cuda.
  preprocess_frames`` (the CUDA kernel on the GPU), then runs the model in
  its compute dtype with an f32 softmax. Frames go host -> device from
  pinned memory, one chunk ahead of the readback (``drain_behind``).
* Frame classification: B-line probability >= threshold -> class 1.
* ``compute_clip_predictions`` / ``compute_frame_predictions`` write the
  same metrics-JSON and predictions-CSV files as the JAX package, into
  ``PATHS.METRICS`` / ``PATHS.BATCH_PREDS`` with timestamped names.
* Frames belong to a clip by clip-name substring match on ``Frame Path``.

pandas and sklearn are imported only by the table functions, so
``Predictor.predict_probs`` and ``group_clip_probs`` run without them.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ab_line_classifier_torch import resolve_device
from ab_line_classifier_torch.config import Config
from ab_line_classifier_torch.data.pipeline import (FRAME_PATH, FrameDataset,
                                                    drain_behind)
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models.common import ModelSpec
from ab_line_classifier_torch.ops import clip_aggregation as agg
from ab_line_classifier_torch.ops.preprocess_cuda import preprocess_frames
from ab_line_classifier_torch.utils import checkpoint as ckpt


def _timestamp() -> str:
    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S")


def load_class_idx_map(cfg: Config) -> Dict[str, int]:
    """Class name -> probability-column index, from ``PATHS.CLASS_NAME_MAP``
    (JSON, or the reference's pickled dict) when that file exists, else
    DATA.CLASSES order. A map that disagrees with DATA.CLASSES warns: the
    model's columns follow DATA.CLASSES at training time."""
    path = cfg["PATHS"].get("CLASS_NAME_MAP", "")
    if path and os.path.isfile(path):
        if path.endswith(".json"):
            with open(path) as f:
                m = {str(k): int(v) for k, v in json.load(f).items()}
        else:
            import pickle
            try:
                with open(path, "rb") as f:
                    m = {str(k): int(v) for k, v in pickle.load(f).items()}
            except Exception as e:  # any unpickling failure: re-raised
                raise ValueError(
                    f"PATHS.CLASS_NAME_MAP {path!r} exists but is neither "
                    f"JSON nor a pickled class->index dict: {e}") from e
        config_order = {c: i for i, c in enumerate(cfg.classes)}
        if m != config_order:
            import warnings
            warnings.warn(
                f"PATHS.CLASS_NAME_MAP {path!r} ({m}) disagrees with "
                f"DATA.CLASSES order ({config_order}); the model's "
                f"probability columns follow DATA.CLASSES at training "
                f"time, so predictions read through this map are likely "
                f"inverted/mislabeled", UserWarning)
        return m
    return {c: i for i, c in enumerate(cfg.classes)}


class Predictor:
    """A restored model on one device, serving uint8 NHWC frames.

    ``compute_dtype`` is the preprocessing output dtype (bfloat16 by
    default, as in the JAX package); the model then runs in its own dtype
    (``spec.dtype``: its parameters are cast to bfloat16 once for a
    mixed-precision model), and the softmax in float32.
    """

    def __init__(self, spec: ModelSpec, state_dict: Dict[str, torch.Tensor],
                 *, batch_size: int = 64,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.spec = spec
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        module = spec.module()
        module.load_state_dict(state_dict)
        self.module = module.eval().to(device=self.device, dtype=spec.dtype,
                                       memory_format=torch.channels_last)
        self._staging: List[Optional[torch.Tensor]] = [None, None]
        self._slot = 0

    @classmethod
    def restore(cls, model_path: str, *, batch_size: int = 64,
                compute_dtype: torch.dtype = torch.bfloat16,
                device=None) -> "Predictor":
        """Restore a port checkpoint directory (``utils/checkpoint.py``)."""
        if model_path.endswith((".h5", ".onnx")):
            raise NotImplementedError(
                f"restoring {model_path!r}: .h5/.onnx import is not ported "
                f"yet (ROADMAP Queue A item 9)")
        state, meta = ckpt.load_model(model_path)
        spec = build_model(meta["model_name"], meta["hparams"],
                           tuple(meta["input_shape"]), int(meta["n_classes"]),
                           mixed_precision=bool(meta.get("mixed_precision",
                                                         False)))
        return cls(spec, state, batch_size=batch_size,
                   compute_dtype=compute_dtype, device=device)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """float32 probabilities for uint8 ``[B, H, W, 3]`` frames already on
        ``self.device``."""
        x = preprocess_frames(frames_u8,
                              out_hw=tuple(self.spec.input_shape[:2]),
                              preprocess_mode=self.spec.preprocess_mode,
                              out_dtype=self.compute_dtype)
        return self.module(x.to(self.spec.dtype)).to(torch.float32)

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        """Copy a uint8 host chunk to the device. On CUDA it goes through
        one of two pinned staging buffers, asynchronously: buffer k is
        reused by chunk k+2, whose launch ``drain_behind`` orders after
        chunk k's readback, so its copy has finished by then."""
        t = torch.from_numpy(np.ascontiguousarray(host))
        if self.device.type != "cuda":
            return t.to(self.device)
        slot = self._slot
        self._slot ^= 1
        buf = self._staging[slot]
        if buf is None or buf.shape[1:] != t.shape[1:] or len(buf) < len(t):
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._staging[slot] = buf
        buf[:len(t)].copy_(t)
        return buf[:len(t)].to(self.device, non_blocking=True)

    def predict_probs(self, frames_u8: np.ndarray) -> np.ndarray:
        """Probabilities for a uint8 ``[N, H, W, 3]`` host frame array, swept
        in chunks of ``batch_size``; chunk k+1 is copied and launched
        before chunk k is read back."""
        n = len(frames_u8)
        bs = self.batch_size
        out = np.zeros((n, self.spec.n_classes), np.float32)

        def launch(i):
            return i, self.forward(self._to_device(frames_u8[i:i + bs]))

        def drain(pending):
            i, probs = pending
            out[i:i + len(probs)] = probs.cpu().numpy()

        drain_behind((launch(i) for i in range(0, n, bs)), drain)
        return out

    def predict_dataset(self, ds: FrameDataset) -> np.ndarray:
        """Decode + predict a frames table: host decode (producer thread),
        host -> device copy, forward and readback all pipelined."""
        out = np.zeros((len(ds), self.spec.n_classes), np.float32)

        def launch(batch):
            return (self.forward(self._to_device(batch.images)),
                    batch.indices, batch.mask)

        def drain(pending):
            probs, indices, mask = pending
            probs = probs.cpu().numpy()
            valid = mask > 0
            out[indices[valid]] = probs[valid]

        drain_behind((launch(b) for b in ds.batches(self.batch_size)), drain)
        return out


def default_predictor(cfg: Config, device=None) -> Predictor:
    """The restore every predict surface shares (``PATHS.MODEL_TO_LOAD``,
    config batch size)."""
    return Predictor.restore(cfg["PATHS"]["MODEL_TO_LOAD"],
                             batch_size=cfg.batch_size, device=device)


def classify_probs(probs: np.ndarray, cfg: Config,
                   threshold: float = 0.5) -> List[int]:
    """Threshold the b_lines probability -> predicted class ids in
    DATA.CLASSES order via the class-index map."""
    idx_map = load_class_idx_map(cfg)
    preds = (probs[:, idx_map["b_lines"]] >= threshold).astype(int)
    idx_class = {v: k for k, v in idx_map.items()}
    classes = cfg.classes
    return [classes.index(idx_class[int(p)]) for p in preds]


def predict_set(predictor: Predictor, frames_df, frames_dir: str,
                cfg: Config, threshold: float = 0.5
                ) -> Tuple[List[int], np.ndarray]:
    """Returns (predicted class ids in DATA.CLASSES order, probabilities)."""
    ds = FrameDataset(frames_df, frames_dir, img_dim=cfg.img_dim)
    probs = predictor.predict_dataset(ds)
    return classify_probs(probs, cfg, threshold), probs


# ----------------------------------------------------------------------
def group_clip_probs(frame_paths: Sequence[str], probs: np.ndarray,
                     clip_names: Sequence[str]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack per-frame probs into a padded ``[n_clips, max_frames, C]`` array
    + mask, grouping frames (``frame_paths``, the frames table's
    ``Frame Path`` column) by clip-name substring match, in table order.
    A clip that matches no frame raises: aggregated as all padding it would
    score as a confident negative."""
    paths = [str(p) for p in frame_paths]
    groups = [np.array([i for i, p in enumerate(paths) if name in p],
                       dtype=np.int64) for name in clip_names]
    empty = [n for n, g in zip(clip_names, groups) if len(g) == 0]
    if empty:
        shown = ", ".join(map(repr, empty[:5]))
        raise ValueError(
            f"{len(empty)} clip(s) in the clips table match no rows of the "
            f"frames table (first: {shown}) — check that FRAME_TABLE and "
            f"CLIPS_TABLE describe the same dataset")
    max_frames = max((len(g) for g in groups), default=1) or 1
    c = probs.shape[1]
    padded = np.zeros((len(clip_names), max_frames, c), np.float32)
    mask = np.zeros((len(clip_names), max_frames), np.float32)
    for i, g in enumerate(groups):
        padded[i, :len(g)] = probs[g]
        mask[i, :len(g)] = 1.0
    return padded, mask


def _write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def compute_clip_predictions(cfg: Config, frames_table_path: str,
                             clips_table_path: str, class_thresh: float = 0.5,
                             clip_algorithm: str = "contiguous",
                             calculate_metrics: bool = True,
                             predictor: Optional[Predictor] = None,
                             frames_dir: Optional[str] = None,
                             frame_probs: Optional[np.ndarray] = None,
                             device=None):
    """Clip predictions (and metrics) for a clips table: one frame sweep,
    then one aggregation on the predictor's device. ``frame_probs`` (rows
    aligned with the frames table) skips the sweep."""
    import pandas as pd

    from ab_line_classifier_torch.predict.metrics import compute_metrics

    if predictor is None:
        predictor = default_predictor(cfg, device)
    frames_dir = frames_dir or cfg["PATHS"]["FRAMES"]
    set_name = os.path.basename(frames_table_path).split(".")[0] + "_clips"

    frames_df = pd.read_csv(frames_table_path)
    clips_df = pd.read_csv(clips_table_path)
    clip_names = clips_df["filename"].astype(str).tolist()
    print(f"Found {len(clip_names)} clips. Determining clip predictions "
          f"with {clip_algorithm} algorithm.")

    if frame_probs is None:
        ds = FrameDataset(frames_df, frames_dir, img_dim=cfg.img_dim)
        frame_probs = predictor.predict_dataset(ds)
    padded, mask = group_clip_probs(frames_df[FRAME_PATH].tolist(),
                                    frame_probs, clip_names)
    dev = predictor.device
    clip_probs = agg.aggregate_clips(
        torch.as_tensor(padded, device=dev), torch.as_tensor(mask, device=dev),
        algorithm=clip_algorithm, classification_threshold=class_thresh,
        contiguity_threshold=int(
            cfg["CLIP_PREDICTION"]["CONTIGUITY_THRESHOLD"]),
        window=int(cfg["CLIP_PREDICTION"]["SLIDING_WINDOW"])).cpu().numpy()

    idx_map = load_class_idx_map(cfg)
    clip_pred_classes = (clip_probs[:, idx_map["b_lines"]]
                         >= class_thresh).astype(int)

    if calculate_metrics:
        clip_labels = clips_df["class"].to_numpy()
        # No AUC for the contiguous algorithm's hard pseudo-probabilities.
        probs_arg = None if clip_algorithm == "contiguous" else clip_probs
        metrics = compute_metrics(cfg.classes, clip_labels, clip_pred_classes,
                                  probs_arg, idx_map)
        _write_json(os.path.join(cfg["PATHS"]["METRICS"],
                                 f"clips_{set_name}{_timestamp()}.json"),
                    metrics)

    pred_probs_df = pd.DataFrame(clip_probs, columns=cfg.classes)
    pred_probs_df.insert(0, "filename", clips_df["filename"])
    if "class" in clips_df.columns:  # absent on unlabeled tables
        pred_probs_df.insert(1, "class", clips_df["class"])
    os.makedirs(cfg["PATHS"]["BATCH_PREDS"], exist_ok=True)
    pred_probs_df.to_csv(os.path.join(
        cfg["PATHS"]["BATCH_PREDS"],
        f"{set_name}_predictions{_timestamp()}.csv"))
    return pred_probs_df


def compute_frame_predictions(cfg: Config, dataset_files_path: str,
                              class_thresh: float = 0.5,
                              calculate_metrics: bool = True,
                              predictor: Optional[Predictor] = None,
                              frames_dir: Optional[str] = None,
                              frame_probs: Optional[np.ndarray] = None,
                              device=None):
    """Frame predictions (and metrics) for a frames table. ``frame_probs``
    (rows aligned with the table) skips the sweep."""
    import pandas as pd

    from ab_line_classifier_torch.predict.metrics import compute_metrics

    if predictor is None:
        predictor = default_predictor(cfg, device)
    frames_dir = frames_dir or cfg["PATHS"]["FRAMES"]
    set_name = os.path.basename(dataset_files_path).split(".")[0] + "_frames"

    files_df = pd.read_csv(dataset_files_path)
    if frame_probs is None:
        pred_classes, pred_probs = predict_set(
            predictor, files_df, frames_dir, cfg, threshold=class_thresh)
    else:
        pred_probs = frame_probs
        pred_classes = classify_probs(pred_probs, cfg, class_thresh)

    if calculate_metrics:
        frame_labels = files_df["Class"].to_numpy()
        metrics = compute_metrics(cfg.classes, frame_labels,
                                  np.asarray(pred_classes), pred_probs,
                                  load_class_idx_map(cfg))
        _write_json(os.path.join(cfg["PATHS"]["METRICS"],
                                 f"frames_{set_name}{_timestamp()}.json"),
                    metrics)

    pred_probs_df = pd.DataFrame(pred_probs, columns=cfg.classes)
    pred_probs_df.insert(0, FRAME_PATH, files_df[FRAME_PATH])
    if "Class" in files_df.columns:  # absent on unlabeled tables
        pred_probs_df.insert(1, "Class", files_df["Class"])
    os.makedirs(cfg["PATHS"]["BATCH_PREDS"], exist_ok=True)
    pred_probs_df.to_csv(os.path.join(
        cfg["PATHS"]["BATCH_PREDS"],
        f"{set_name}_predictions{_timestamp()}.csv"))
    return pred_probs_df
