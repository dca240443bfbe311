"""Inference: frame predictions, clip predictions, metrics/CSV contracts
(port of the JAX package's ``predict/predict.py``).

* :class:`Predictor` restores a port checkpoint, or a Keras ``.h5`` or
  ``.onnx`` file, and serves uint8 frames:
  every forward preprocesses through ``ops.preprocess_cuda.
  preprocess_frames`` (the CUDA kernel on the GPU), then runs the model in
  its compute dtype with an f32 softmax. Frames go host -> device from
  pinned memory, one chunk ahead of the readback (``drain_behind``).
* Frame classification: B-line probability >= threshold -> class 1.
* ``compute_clip_predictions`` / ``compute_frame_predictions`` write the
  same metrics-JSON and predictions-CSV files as the JAX package, into
  ``PATHS.METRICS`` / ``PATHS.BATCH_PREDS`` with timestamped names (rank
  0 alone under a process group).
* Frames belong to a clip by clip-name substring match on ``Frame Path``.

pandas and sklearn are imported only by the table functions, so
``Predictor.predict_probs`` and ``group_clip_probs`` run without them.

With a device mesh (``parallel/mesh.py``; ``default_predictor`` reads
``PARALLEL.MESH``) serving spreads over every rank, trial x data
flattened: the chunk is rounded up to a multiple of the world size, each
rank serves its rows of every chunk through B1 and the model (its own
pinned staging buffers), and an ``all_gather`` returns the whole
probability array on every rank, the API unchanged. Each rank is given
the same weights (restored from the same checkpoint); nothing is
broadcast.
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
                                                    PinnedStaging,
                                                    drain_behind)
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models.common import ModelSpec
from ab_line_classifier_torch.models.onnx_weights import import_onnx_state
from ab_line_classifier_torch.models.weights import import_h5_state
from ab_line_classifier_torch.ops import clip_aggregation as agg
from ab_line_classifier_torch.ops.preprocess_cuda import preprocess_frames
from ab_line_classifier_torch.parallel import mesh as mesh_lib
from ab_line_classifier_torch.utils import checkpoint as ckpt
from ab_line_classifier_torch.utils.profiling import annotate


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


def load_module(spec: ModelSpec, state_dict: Dict[str, torch.Tensor],
                device: torch.device) -> torch.nn.Module:
    """``spec``'s module with ``state_dict`` loaded, in eval mode, on
    ``device`` in ``spec.dtype`` and channels_last memory: the form every
    serving and explaining path runs."""
    module = spec.module()
    module.load_state_dict(state_dict)
    return module.eval().to(device=device, dtype=spec.dtype,
                            memory_format=torch.channels_last)


class Predictor:
    """A restored model on one device, serving uint8 NHWC frames.

    ``compute_dtype`` is the preprocessing output dtype (bfloat16 by
    default, as in the JAX package); the model then runs in its own dtype
    (``spec.dtype``: its parameters are cast to bfloat16 once for a
    mixed-precision model), and the softmax in float32. ``weights`` is the
    state dict it was given (float32 master weights where the checkpoint
    holds them), which the ONNX export writes. With ``mesh`` (this rank's
    ``device``) the batch size rounds up to a multiple of the mesh's size
    and each rank serves its rows of every chunk.
    """

    def __init__(self, spec: ModelSpec, state_dict: Dict[str, torch.Tensor],
                 *, batch_size: int = 64,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 mesh=None):
        self.device = resolve_device(device)
        self.spec = spec
        self.mesh = mesh
        if mesh is not None:
            n_dev = mesh.size()
            batch_size = -(-batch_size // n_dev) * n_dev
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.weights = state_dict
        self.module = load_module(spec, state_dict, self.device)
        self._staging = PinnedStaging(self.device)

    @classmethod
    def restore(cls, model_path: str, *, batch_size: int = 64,
                compute_dtype: torch.dtype = torch.bfloat16,
                device=None, cfg: Optional[Config] = None,
                mesh=None) -> "Predictor":
        """Restore a port checkpoint directory (``utils/checkpoint.py``),
        or a Keras ``.h5`` or an ``.onnx`` file (the reference's serving
        formats). A file needs ``cfg`` for the architecture
        (``TRAIN.MODEL_DEF`` + ``HPARAMS``, ``DATA.IMG_DIM``): the model is
        rebuilt in float32, as the JAX package does, and the weights are
        imported by layer name (``models/weights.py``,
        ``models/onnx_weights.py``); a file that matches no layer raises."""
        if model_path.endswith((".h5", ".onnx")):
            if cfg is None:
                raise ValueError(
                    f"restoring {model_path!r} needs cfg to rebuild the "
                    f"architecture (TRAIN.MODEL_DEF + HPARAMS)")
            spec = build_model(cfg.model_name, cfg.model_hparams(),
                               cfg.img_dim + (3,), cfg.n_classes)
            importer = (import_onnx_state if model_path.endswith(".onnx")
                        else import_h5_state)
            state, copied = importer(model_path, spec.module().state_dict(),
                                     graph=spec.graph, verbose=False)
            if copied == 0:
                raise ValueError(
                    f"no layers matched while importing {model_path!r}")
            return cls(spec, state, batch_size=batch_size,
                       compute_dtype=compute_dtype, device=device, mesh=mesh)
        state, meta = ckpt.load_model(model_path)
        spec = build_model(meta["model_name"], meta["hparams"],
                           tuple(meta["input_shape"]), int(meta["n_classes"]),
                           mixed_precision=bool(meta.get("mixed_precision",
                                                         False)))
        return cls(spec, state, batch_size=batch_size,
                   compute_dtype=compute_dtype, device=device, mesh=mesh)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """float32 probabilities for uint8 ``[B, H, W, 3]`` frames already on
        ``self.device``."""
        with annotate("predict.preprocess"):
            x = preprocess_frames(frames_u8,
                                  out_hw=tuple(self.spec.input_shape[:2]),
                                  preprocess_mode=self.spec.preprocess_mode,
                                  out_dtype=self.compute_dtype)
        with annotate("predict.model"):
            return self.module(x.to(self.spec.dtype)).to(torch.float32)

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        """Copy a uint8 host chunk to the device: on CUDA through one of
        two pinned staging buffers, asynchronously (:class:`PinnedStaging`),
        so chunk k+1's copy overlaps chunk k's work."""
        return self._staging(np.ascontiguousarray(host))[0]

    def predict_probs(self, frames_u8: np.ndarray) -> np.ndarray:
        """Probabilities for a uint8 ``[N, H, W, 3]`` host frame array, swept
        in chunks of ``batch_size``; chunk k+1 is copied and launched
        before chunk k is read back. Under a mesh each rank serves its
        rows of a chunk (the chunk split evenly over the ranks, zero
        frames padding the last rank's share of a ragged chunk) and every
        rank gets the whole array."""
        n = len(frames_u8)
        bs = self.batch_size
        out = np.zeros((n, self.spec.n_classes), np.float32)

        def launch(i):
            chunk = frames_u8[i:i + bs]
            if self.mesh is None:
                return i, len(chunk), self.forward(self._to_device(chunk))
            per = -(-len(chunk) // self.mesh.size())
            r = mesh_lib.rank()
            local = np.zeros((per,) + chunk.shape[1:], chunk.dtype)
            part = chunk[r * per:(r + 1) * per]
            local[:len(part)] = part
            return i, len(chunk), self.forward(self._to_device(local))

        def drain(pending):
            i, k, probs = pending
            if self.mesh is not None:
                probs = mesh_lib.all_gather_rows(
                    probs, mesh_lib.world_group())[:k]
            out[i:i + k] = probs.cpu().numpy()

        drain_behind((launch(i) for i in range(0, n, bs)), drain)
        return out

    def predict_dataset(self, ds: FrameDataset) -> np.ndarray:
        """Decode + predict a frames table: host decode (producer thread),
        host -> device copy, forward and readback all pipelined. Under a
        mesh each rank decodes and serves its rows of every batch, and one
        ``all_reduce`` at the end (each valid row from one rank, zeros
        from the others: exact) gives every rank the whole array."""
        out = np.zeros((len(ds), self.spec.n_classes), np.float32)
        rows = (None if self.mesh is None else
                mesh_lib.full_batch_sharding(self.mesh, self.batch_size))

        def launch(batch):
            return (self.forward(self._to_device(batch.images)),
                    batch.indices, batch.mask)

        def drain(pending):
            probs, indices, mask = pending
            probs = probs.cpu().numpy()
            valid = mask > 0
            out[indices[valid]] = probs[valid]

        drain_behind((launch(b) for b in ds.batches(self.batch_size,
                                                    rows=rows)), drain)
        if self.mesh is not None:
            total = torch.from_numpy(out).to(mesh_lib.backend_device())
            mesh_lib.all_reduce_tensors([total], mesh_lib.world_group())
            out = total.cpu().numpy()
        return out


def default_predictor(cfg: Config, device=None) -> Predictor:
    """The restore every predict surface shares (``PATHS.MODEL_TO_LOAD``, a
    checkpoint directory or a ``.h5`` / ``.onnx`` file; config batch
    size; the mesh of ``PARALLEL.MESH`` under a process group)."""
    return Predictor.restore(cfg["PATHS"]["MODEL_TO_LOAD"],
                             batch_size=cfg.batch_size, device=device,
                             cfg=cfg,
                             mesh=mesh_lib.mesh_from_config(cfg, device))


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
    if not mesh_lib.is_main():
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def _write_predictions(df, cfg: Config, set_name: str) -> None:
    """The predictions CSV (rank 0 only)."""
    if not mesh_lib.is_main():
        return
    os.makedirs(cfg["PATHS"]["BATCH_PREDS"], exist_ok=True)
    df.to_csv(os.path.join(cfg["PATHS"]["BATCH_PREDS"],
                           f"{set_name}_predictions{_timestamp()}.csv"))


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
    _write_predictions(pred_probs_df, cfg, set_name)
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
    _write_predictions(pred_probs_df, cfg, set_name)
    return pred_probs_df
