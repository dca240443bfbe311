"""WaveBase deploy serving and train/serve preprocessing parity (port of
the JAX package's ``predict/deploy.py``; the reference's ``src/deploy.py``).

``predict_wavebase_mp4`` serves a clip as the probe does: the 50x160
top-left UI box blanked, cv2's INTER_NEAREST index map, the model's
scaling, float32 into the model, A/B probabilities per frame written as
``Frame, A lines, B lines``. On the card the whole clip goes up once, kernel
B1 (``csrc/preprocess.cu``) runs once at the clip's source size and the
model runs one batched forward. ``ab_classifier_preprocess`` is the
reference's host preprocessing for one frame, which
``check_preprocess_parity`` holds B1 against.

cv2 is imported by ``decode_mp4_frames`` only; pass ``frames=`` where it is
not installed.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ab_line_classifier_torch import resolve_device
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models.common import ModelSpec
from ab_line_classifier_torch.models.registry import (get_model,
                                                      get_preprocess_mode)
from ab_line_classifier_torch.ops.image import nearest_indices
from ab_line_classifier_torch.ops.preprocess_cuda import preprocess_frames
from ab_line_classifier_torch.predict.predict import load_module
from ab_line_classifier_torch.utils import checkpoint as ckpt
from ab_line_classifier_torch.utils.tables import write_table

INPUT_SIZE = (128, 128)
N_CHANNELS = 3


def ab_classifier_preprocess(image: np.ndarray,
                             preprocessing_fn: Callable) -> np.ndarray:
    """The reference's ``AB_classifier_preprocess`` on the host: cv2
    INTER_NEAREST resize of a ``(1, H, W, 3)`` frame to 128x128 (cv2's
    index map, without cv2) and the model's scaling, float32."""
    frame = np.asarray(image)[0]
    h, w = frame.shape[:2]
    ridx = nearest_indices(h, INPUT_SIZE[0], "cv2")
    cidx = nearest_indices(w, INPUT_SIZE[1], "cv2")
    resized = frame[ridx][:, cidx].astype(np.float32)
    resized = resized.reshape((1, INPUT_SIZE[0], INPUT_SIZE[1], N_CHANNELS))
    return preprocessing_fn(torch.from_numpy(resized)).numpy()


def decode_mp4_frames(mp4_path: str) -> np.ndarray:
    """All frames of an mp4 as uint8 ``[T, H, W, 3]`` RGB."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("cv2 is required for mp4 decode (or pass "
                           "pre-decoded frames=)") from e
    vc = cv2.VideoCapture(mp4_path)
    frames = []
    while True:
        ret, frame = vc.read()
        if not ret:
            break
        frames.append(frame[..., ::-1])
    vc.release()
    if not frames:
        raise ValueError(f"no frames decoded from {mp4_path!r}")
    return np.stack(frames)


def load_deploy_model(model_path: str, device=None
                      ) -> Tuple[ModelSpec, torch.nn.Module]:
    """A port checkpoint's spec and module, in eval mode on ``device``
    (``scripts/orbax_to_torch.py`` converts the JAX package's)."""
    device = resolve_device(device)
    state, meta = ckpt.load_model(model_path)
    spec = build_model(meta["model_name"], meta["hparams"],
                       tuple(meta["input_shape"]), int(meta["n_classes"]),
                       mixed_precision=bool(meta.get("mixed_precision",
                                                     False)))
    return spec, load_module(spec, state, device)


def deploy_preprocess(spec: ModelSpec, frames: torch.Tensor) -> torch.Tensor:
    """One launch of B1 over a clip's uint8 frames at their source size
    (the plain version for a CPU tensor): the UI box blanked, cv2's map to
    the checkpoint's input size, the model's scaling, float32 out. The
    reference fixes 128x128; serving the checkpoint's own size is the same
    there and works for models trained at other sizes."""
    return preprocess_frames(frames, out_hw=tuple(spec.input_shape[:2]),
                             preprocess_mode=spec.preprocess_mode,
                             resize_mode="cv2", blank_ui_region=True,
                             out_dtype=torch.float32)


@torch.inference_mode()
def deploy_forward(spec: ModelSpec, module: torch.nn.Module,
                   frames: torch.Tensor) -> torch.Tensor:
    """float32 ``[T, n_classes]`` probabilities of a clip on the module's
    device: :func:`deploy_preprocess`, then one batched forward in the
    model's dtype."""
    x = deploy_preprocess(spec, frames)
    return module(x.to(spec.dtype)).to(torch.float32)


def write_preds_csv(preds: np.ndarray, preds_path: str) -> None:
    """The reference's ``Frame, A lines, B lines`` CSV, as pandas writes
    it."""
    preds = np.asarray(preds, np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(preds_path)), exist_ok=True)
    write_table(preds_path, {"Frame": np.arange(len(preds)),
                             "A lines": preds[:, 0], "B lines": preds[:, 1]})


def predict_wavebase_mp4(model_path: str, mp4_path: str, preds_path: str,
                         frames: Optional[np.ndarray] = None,
                         device=None) -> np.ndarray:
    """The reference's ``predict_wavebase_mp4``: framewise probabilities
    over a clip with the UI box blanked, written to ``preds_path``; runs on
    ``device`` (``cuda`` unless the caller asks for the CPU).

    :param frames: pre-decoded uint8 ``[T, H, W, 3]`` RGB frames (skips the
        mp4 decode)."""
    device = resolve_device(device)
    if frames is None:
        frames = decode_mp4_frames(mp4_path)
    spec, module = load_deploy_model(model_path, device)
    clip = torch.from_numpy(np.ascontiguousarray(frames)).to(
        next(module.parameters()).device)
    preds = deploy_forward(spec, module, clip).cpu().numpy()
    write_preds_csv(preds, preds_path)
    return preds


def check_preprocess_parity(frame: np.ndarray, model_name: str,
                            device=None) -> float:
    """Train/serve parity: max |host reference - B1| for one frame (on the
    card; the plain version on the CPU), 128x128, cv2's map."""
    _, preprocessing_fn = get_model(model_name)
    host = ab_classifier_preprocess(frame[None], preprocessing_fn)
    dev = resolve_device(device)
    served = preprocess_frames(
        torch.from_numpy(np.ascontiguousarray(frame[None])).to(dev),
        out_hw=INPUT_SIZE, preprocess_mode=get_preprocess_mode(model_name),
        resize_mode="cv2").cpu().numpy()
    return float(np.abs(host - served).max())
